"""The canonical YOLaT detector as PyTorch modules (eval forward)."""
