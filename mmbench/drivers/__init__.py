"""Traffic drivers, one a file, found by the name a traffic file gives."""
