"""Command-line tools of the port (``python -m dat_segmentation_tpu_torch.tools.<name>``)."""
