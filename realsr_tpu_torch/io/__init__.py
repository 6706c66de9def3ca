"""Image I/O: jpg/png/webp codecs with native (C++) and PIL backends."""

from realsr_tpu_torch.io.codecs import decode_image, encode_image

__all__ = ["decode_image", "encode_image"]
