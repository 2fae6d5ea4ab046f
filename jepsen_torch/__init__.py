"""jepsen_torch — the PyTorch/CUDA port of jepsen_tpu's linearizability
check.

Batches of histories are encoded on the host into event tensors and
transition tables, searched on an NVIDIA H100 by a hand-written CUDA
kernel (``ops/csrc/wgl_frontier.cu``), and decoded into per-history
verdicts with a first bad op and a Knossos-style config sample. Entry
points: ``ops.linearize.check_batch`` / ``check_one`` and the
``checkers.linearizable`` backends. They run on the card unless the
caller passes ``device="cpu"``, where the plain PyTorch version of the
kernel runs instead.

Importing the package imports torch and numpy only; the kernel is built
at its first launch.
"""
