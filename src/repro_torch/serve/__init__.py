from .engine import (BatchedServer, ServeConfig, make_decode_fn,
                     make_prefill_step)

__all__ = ["BatchedServer", "ServeConfig", "make_decode_fn",
           "make_prefill_step"]
