"""Measurement and validation scripts of the port, run as modules:

    python -m minimodem_tpu_torch.scripts.sp_scaling_curve [audio_seconds] [batch]
    python -m minimodem_tpu_torch.scripts.live_soak --selfcheck
"""
