"""The canonical YOLaT detector as PyTorch modules (train and eval)."""
