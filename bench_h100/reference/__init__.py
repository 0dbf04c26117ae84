"""The plain reference: the same networks, losses, augmentation and
optimizer step in plain PyTorch, float32 with TF32 off. It imports
nothing of the program and takes nothing the program made: it is handed
the benchmark's own weights and slices and works out the rest again.

Each configuration's network is a module of its own here,
``<name>.py``, named by the configuration's top-level key
``"reference"``; a configuration without the key takes ``model.py``
(the bilinear UNet and AttentionUNet). The harness loads it by path
(``common.load_reference``), so a new architecture comes as a new file,
and takes four things from it:

* ``Net(model_cfg)``: the network in float32, its state dict's names
  those of the program's, so that one state dict loads into both;
* ``set_fp8(net, on)``: the control, which rounds the inputs and
  weights of every matrix operation of the net to float8;
* ``flops_per_slice(model_cfg, img) -> int``: the forward operations of
  one img^2 slice, which ``mfu.train`` counts;
* ``init_plan(shapes) -> {leaf: kind}``: for each leaf of the state dict
  (name to shape), how ``weights.seeded_state`` draws it.
"""

import torch


def strict_fp32() -> None:
    """float32 convolutions and matrix products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
