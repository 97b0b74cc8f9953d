"""The benchmark of ``cswin_unet_tpu_torch`` on NVIDIA GPUs (``run.py``)."""
