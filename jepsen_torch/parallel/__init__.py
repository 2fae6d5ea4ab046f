"""Device-mesh parallelism for the batched checker.

Two orthogonal axes, as in the reference (``jepsen_tpu/parallel``):

  data     — histories per batch: embarrassingly parallel; the batch
             axis of the encoded tensors is cut over the mesh and each
             shard is checked on its own device by the single-device
             kernel (K1).
  frontier — within one history, the WGL configuration frontier's mask
             axis (2^W pending subsets) splits across devices. Applies
             on device-local mask bits stay local; applies and
             completions on the top log2(D) bits are exchanges between
             hypercube partners.

The mesh is driven from one process: a grid of ``torch.device``s, an
exchange is a tensor copy to the partner's device, and a reduction is
one over small flag tensors. ``jepsen_torch.provision`` names the
devices the production routes see.
"""
from .frontier import frontier_sharded_kernel
from .mesh import Mesh, checker_mesh, data_sharded_kernel, multihost_mesh
