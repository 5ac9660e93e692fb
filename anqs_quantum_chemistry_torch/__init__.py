"""PyTorch/CUDA port of ``anqs_quantum_chemistry_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps the
name and layout of its counterpart there, and the tests
(``tests/test_torch_*.py``) hold each one against it on the same inputs. This
package imports ``torch``, numpy and scipy only -- never JAX, nor anything of
the JAX package.

Slice 1 covers the main training path: N2/STO-3G, MADE ansatz, Gumbel top-k
sampling of the whole (N_alpha, N_beta) sector, sector membership, MinSR and
Adam (``experiments.vmc.VMC``). Its one hand-written kernel is
``ops.matrix_elements.fused_matrix_elements`` (``csrc/fused_me.cu``).

Energy-critical float32 products must be exact float32, as the JAX package
pins them to ``Precision.HIGHEST``: TF32 is switched off for the whole process
on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
