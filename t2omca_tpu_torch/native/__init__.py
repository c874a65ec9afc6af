"""Host code the port builds at first use (the sum-tree of the host-RAM
replay's tests)."""

from .build import NativeBuildError, load_sumtree

__all__ = ["NativeBuildError", "load_sumtree"]
