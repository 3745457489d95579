"""Build and runtime capabilities of the PyTorch port.

Counterpart of ``mxtpu/libinfo.py``: ``find_lib_path`` lists the native
libraries the port has built, and ``features`` reports what this
process can use.  The keys that mean the same as the JAX package's keep
their names (``NATIVE_ENGINE``, ``BF16``, ``INT8_QUANTIZATION``,
``DIST_KVSTORE``, ``C_PREDICT_ABI``, ``C_API``); its ``TPU``, ``PALLAS``
and ``CPU_MESH`` become ``CUDA`` (a card is present) and
``CUDA_KERNELS`` (``nvcc`` is there to build the port's kernels).  The
port has no C ABI yet (ROADMAP A19), so ``C_PREDICT_ABI`` and ``C_API``
are False.
"""
__version__ = "0.1.0"

__all__ = ["features", "find_lib_path", "__version__"]


def find_lib_path():
    """The native libraries built under ``mxtpu_torch/_build/``."""
    from .engine import BUILD_DIR

    return sorted(str(p) for p in BUILD_DIR.glob("*.so")) \
        if BUILD_DIR.is_dir() else []


def features():
    """Capability name -> bool, probed in this process."""
    import torch

    from . import engine
    from .ops import kernel_build

    feats = {"CUDA": torch.cuda.is_available()}
    try:
        kernel_build.nvcc_path()
        feats["CUDA_KERNELS"] = True
    except Exception:
        feats["CUDA_KERNELS"] = False
    try:
        engine._cxx()
        feats["NATIVE_ENGINE"] = True
    except Exception:
        feats["NATIVE_ENGINE"] = engine.library_path().exists()
    feats["C_PREDICT_ABI"] = False
    feats["C_API"] = False
    feats["BF16"] = True
    feats["INT8_QUANTIZATION"] = True
    feats["DIST_KVSTORE"] = True
    return feats
