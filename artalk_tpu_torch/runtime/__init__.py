"""Native (C++) host runtime: media kernels behind ctypes bindings.

The port's own copy of ``artalk_tpu/runtime``: the resampler that audio
ingest uses and the Y4M writer of the video fallback. The library is built
on demand with g++ (the same flags as the JAX package's, so both resample to
the same samples on one host) and cached; every entry point has a NumPy or
scipy fallback, the JAX package's, when no compiler is found.
"""

from .media import (native_available, resample_poly, rgb_to_yuv420, write_y4m,
                    write_y4m_planar)

__all__ = ["native_available", "resample_poly", "rgb_to_yuv420", "write_y4m",
           "write_y4m_planar"]
