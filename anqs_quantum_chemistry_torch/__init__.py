"""PyTorch/CUDA port of ``anqs_quantum_chemistry_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps the
name and layout of its counterpart there, and the tests
(``tests/test_torch_*.py``) hold each one against it on the same inputs. This
package imports ``torch``, numpy and scipy only -- never JAX, nor anything of
the JAX package.

It trains on one card (``experiments.vmc.VMC`` and its ``run`` loop, with
checkpoints, schedules and distillation cycles): the N2/STO-3G main path
(MADE, Gumbel sampling of the whole sector, sector membership), the Li2O
toy model (hash membership), the C2H4/6-31G transformer trainer and the
Li2O NADE campaign (prefilter membership; CISD targets,
``chem.fci.cisd_ground_state``, and supervised pretraining,
``optim.pretrain``), with exact summation, multinomial sampling, MinSR and
Adam; and the Li2O support-CI closure (selected CI on the host,
``chem.selected_ci`` with the C++ Slater-Condon builder ``chem.native``;
distillation, the full-support polish and support-restricted VMC,
``experiments.support_ci``); and the C2H4/6-31G CISD -> support-CI chain
(CISD from the packaged integrals, the CISD-pretrained MADE-2048 and
transformer, ``experiments.cisd_pretrain_vmc``; the closure and its
transformer leg, ``experiments.c2h4_support_ci`` and
``c2h4_support_transformer``). The nets' matmul precision is
``AnqsConfig.matmul_precision`` (``models.precision``). Its two hand-written kernels replace the JAX package's two Pallas
kernels: ``ops.matrix_elements.fused_matrix_elements``
(``csrc/fused_me.cu``) and ``ops.hash_lookup.hash_lookup``
(``csrc/hash_lookup.cu``). The entry points are the modules of
``experiments/``.

Energy-critical float32 products must be exact float32, as the JAX package
pins them to ``Precision.HIGHEST``: TF32 is switched off for the whole process
on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
