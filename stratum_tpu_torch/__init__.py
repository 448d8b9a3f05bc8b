"""stratum_tpu_torch: the PyTorch + CUDA port of the stratum_tpu renderer.

The JAX package (``stratum_tpu``) is the reference; this package keeps its
subpackage layout (``core/ ops/ render/ scene/``) and module names so the
counterpart of every module is easy to find. It imports ``torch`` and never
``jax``. The hot ray-triangle loop runs in a hand-written CUDA kernel
(``csrc/block_trace.cu``, bound in ``ops/block_trace.py``); everything
around it is plain torch.

TF32 is switched off here, where the port starts: camera, shading and the
Plucker ray features must stay full f32 (TF32 keeps ~10 mantissa bits).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
