"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

The package mirrors the JAX reference tree (``configs/``, ``moa/``,
``kernels/``, ``layers/``, ``models/``, ``optim/``, ``data/``, ``serve/``,
``runtime/``, ``checkpoint/``, ``launch/``) so each module's counterpart is
found by path. It imports ``torch`` and never ``jax`` or anything of
``repro``. Every TPU kernel on the served and trained paths is a
hand-written CUDA C++ kernel for ``sm_90a`` (``kernels/csrc/``), built with
``nvcc`` at first use; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead, which is how the CPU tests reach the math. The
kernels have no backward: training reaches ``dot_moa`` and ``moa_reduce``
through the MOA backends' ``autograd.Function`` wrappers (the reference's
``custom_vjp`` rules) and attention through its plain twin, as the
reference's training forward does.

Entry points (``models.api.build_model(cfg).init``,
``serve.engine.ServeEngine``, ``launch.train.TrainLoop``, ``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``) run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU they
raise.
"""
