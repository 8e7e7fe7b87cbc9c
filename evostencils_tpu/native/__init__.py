"""Native (C++) components of the framework.

The reference relies on external native systems for its numeric and
analysis hot paths (ExaStencils-generated C++ solvers, the C++ LFA Lab
library — SURVEY.md §2.3).  This framework keeps device compute in
XLA and implements the host-side native pieces here, built
on demand with g++ and loaded through ctypes (no pybind11 in the image).
"""

from .build import lfa_engine_available, load_lfa_engine  # noqa: F401
