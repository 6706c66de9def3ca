"""realsr_tpu_torch — the PyTorch/CUDA port of realsr_tpu for NVIDIA Hopper.

The JAX package ``realsr_tpu`` is the reference; this package computes the
same RealSR x4 super-resolution (ncnn ``.param``/``.bin`` models, RRDBNet,
halo-padded tiles with reflect-101 borders, uint8 rounding, bicubic alpha)
with PyTorch, and runs the RRDB trunk and the tail after it on hand-written
CUDA kernels for ``sm_90a`` (``csrc/rdb_wgmma.cu``, ``csrc/rdb_tf32.cu``,
``csrc/rdb_modes_wgmma.cu``, ``csrc/rdb_modes_tf32.cu``,
``csrc/tail_kernel.cu``, ``csrc/tail_tf32.cu``). It also runs Real-SwinIR
(a ``.json`` of its settings and a ``.pth`` state dict), whose window
attention and residual LayerNorms have kernels of their own
(``csrc/swin_kernel.cu``) and whose tail is RRDBNet's. The kernels are built with nvcc at first
use in groups of instances into a cache scoped by the host's fingerprint
(``ops/build.py``); ``python -m realsr_tpu_torch.seed_cache`` ships them to
hosts without nvcc. It imports no JAX.

The public facade is :class:`realsr_tpu_torch.engine.RealSR`.
"""

__all__ = ["RealSR", "EngineConfig", "__version__"]


def __getattr__(name):
    # Lazy: importing the facade pulls in torch; keep bare imports light.
    if name in ("RealSR", "EngineConfig"):
        from realsr_tpu_torch import engine

        return getattr(engine, name)
    if name == "__version__":
        from realsr_tpu_torch.version import __version__

        return __version__
    raise AttributeError(name)
