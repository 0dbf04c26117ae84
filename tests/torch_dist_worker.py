"""One rank of the port's 2-process checks in tests/test_torch_distributed.py
(not a test module).

    python tests/torch_dist_worker.py COORDINATOR RANK WORLD DIR

joins a gloo process group on the CPU, reads ``DIR/inputs.npz`` and
``DIR/weights.pt`` (written by the test) and writes ``DIR/rank{RANK}.pt``:

* ``bn``: a training-mode ``TorchBatchNorm`` on this rank's rows of ``x``
  with the upstream gradient ``g``: output, input and parameter
  gradients, running statistics;
* ``grads``, ``loss``: ``TrainStep.accumulate`` (one microbatch) of
  AttentionUNet base 8 on this rank's rows of the fixed batch: the
  gradients and loss after the step's one reduction over the ranks;
* ``after``: the model's state dict and the EMA shadow after one full
  optimizer step (clip, AdamW, EMA) on the same rows.
"""

import sys

import numpy as np
import torch


def main():
    coordinator, rank, world, out = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    from unet_tpu_torch.core.distributed import init_distributed
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.models.layers import TorchBatchNorm
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.train.trainer import (create_optimizer, ema_reinit,
                                              make_train_step)

    init_distributed(coordinator, world, rank, 'cpu', timeout_seconds=120)
    data = np.load(f'{out}/inputs.npz')

    def rows(a):
        lb = a.shape[0] // world
        return torch.from_numpy(np.ascontiguousarray(
            a[rank * lb:(rank + 1) * lb]))

    result = {}
    bn = TorchBatchNorm(data['x'].shape[1])
    bn.load_state_dict({k: torch.from_numpy(data[f'bn_{k}'])
                        for k in ('weight', 'bias', 'running_mean',
                                  'running_var')}
                       | {'num_batches_tracked': torch.tensor(0)})
    bn.train()
    x = rows(data['x']).requires_grad_(True)
    y = bn(x)
    (y * rows(data['g'])).sum().backward()
    result['bn'] = {'out': y.detach(), 'dx': x.grad,
                    'dweight': bn.weight.grad, 'dbias': bn.bias.grad,
                    'running_mean': bn.running_mean.clone(),
                    'running_var': bn.running_var.clone(),
                    'num_batches_tracked': bn.num_batches_tracked.clone()}

    model = create_model('attention_unet', base_features=8)
    model.load_state_dict(torch.load(f'{out}/weights.pt'), strict=True)
    model = model.to(memory_format=torch.channels_last)
    opt = create_optimizer(model, 1e-3)
    step = make_train_step(model, create_loss_function('dice_bce'), opt,
                           accum_steps=1, grad_clip=1.0, use_ema=True)
    imgs = rows(data['imgs']).permute(0, 3, 1, 2)[None]
    msks = rows(data['msks'])[None]
    result['loss'] = step.accumulate(imgs, msks, [1.0])
    result['grads'] = {k: p.grad.clone() for k, p in
                       model.named_parameters()}
    ema = ema_reinit(model)
    step(imgs, msks, 1e-3, [1.0], ema)
    result['after'] = {'model': model.state_dict(),
                       'ema': ema.state_dict()}
    torch.save(result, f'{out}/rank{rank}.pt')
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
