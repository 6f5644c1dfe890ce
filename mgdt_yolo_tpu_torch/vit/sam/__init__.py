from .model import SAM, Sam

__all__ = ["SAM", "Sam"]
