"""The port's native (C++) host pipeline: see loader.py and
jpeg_loader.cpp."""

from .loader import (available, decode_eval_batch, decode_square_batch,
                     decode_train_batch, probe, unavailable_reason)

__all__ = ["available", "decode_eval_batch", "decode_square_batch",
           "decode_train_batch", "probe", "unavailable_reason"]
