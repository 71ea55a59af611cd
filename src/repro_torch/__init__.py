"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

The package mirrors the JAX reference tree (``configs/``, ``moa/``,
``kernels/``, ``layers/``, ``models/``, ``serve/``, ``launch/``) so each
module's counterpart is found by path. It imports ``torch`` and never
``jax`` or anything of ``repro``. Every TPU kernel on the served path is a
hand-written CUDA C++ kernel for ``sm_90a`` (``kernels/csrc/``), built with
``nvcc`` at first use; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead, which is how the CPU tests reach the math.

Entry points (``models.api.build_model(cfg).init``,
``serve.engine.ServeEngine``, ``python -m repro_torch.launch.serve``) run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU they raise.
"""
