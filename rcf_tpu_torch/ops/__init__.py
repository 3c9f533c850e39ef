from .resize import resize_bilinear, resize_nearest  # noqa: F401
