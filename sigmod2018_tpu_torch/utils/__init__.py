from .padding import pad_to, size_class

__all__ = ["pad_to", "size_class"]
