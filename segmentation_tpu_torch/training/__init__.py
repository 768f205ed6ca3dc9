"""Training: losses and metrics, and the segmentation trainer."""
