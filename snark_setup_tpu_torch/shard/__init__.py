from .runtime import pad_width, put_points, put_scalars, scalar_mul

__all__ = ["pad_width", "put_points", "put_scalars", "scalar_mul"]
