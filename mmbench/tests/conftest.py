import sys
from pathlib import Path

# the cells' tiny sizes (_cells.py) import from here
sys.path.insert(0, str(Path(__file__).resolve().parent))
