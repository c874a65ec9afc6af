"""PyTorch/CUDA port of ``t2omca_tpu`` for one NVIDIA H100.

A package of its own beside the JAX reference: it imports torch, numpy
and the standard library, never JAX, flax or ``t2omca_tpu``. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``
(``device.py``). The layout mirrors the JAX package; ``ROADMAP.md`` says
which slices are ported (greedy serving, the trainer step with the
hand-written flash-attention kernels in ``kernels/``, the classic
training loop: env, rollout, insert, train, and the driver around it:
``python -m t2omca_tpu_torch train|evaluate|benchmark``).
"""
