"""One rank of the port's 2-process checks in tests/test_torch_distributed.py
(not a test module).

    python tests/torch_dist_worker.py COORDINATOR RANK WORLD DIR [MODE]

joins a gloo process group on the CPU, reads ``DIR/inputs.npz`` and
``DIR/weights.pt`` (written by the test) and writes ``DIR/rank{RANK}.pt``.
MODE ``step`` (the default) writes:

* ``bn``: a training-mode ``TorchBatchNorm`` on this rank's rows of ``x``
  with the upstream gradient ``g``: output, input and parameter
  gradients, running statistics;
* ``grads``, ``loss``: ``TrainStep.accumulate`` (one microbatch) of
  AttentionUNet base 8 on this rank's rows of the fixed batch: the
  gradients and loss after the step's one reduction over the ranks;
* ``after``: the model's state dict and the EMA shadow after one full
  optimizer step (clip, AdamW, EMA) on the same rows.

MODE ``weighted_ce`` runs class-weighted cross entropy
(``CLASS_WEIGHTS``) and reads ``DIR/weights_ds{0,1}.pt`` (AttentionUNet
base 8 without and with deep supervision); it writes:

* ``ds0``, ``ds1``: ``{'loss', 'grads'}`` of ``TrainStep.accumulate`` on
  this rank's rows of the fixed batch, after the step's reduction;
* ``val_loss``: the validation loss over ``val_imgs``/``val_msks`` in
  global batches of the train batch's size (the last one short, padded
  as the loader's ``pad_tail`` pads it, by repeating its last row), each
  rank evaluating its rows with weight 0 on the padding, combined by
  ``train.trainer.validation_loss`` as the train CLI combines them;
  ``val_batch_losses``, this rank's loss of each batch before that;
* ``alone`` (rank 0 only): the loss of its rows, evaluated by rank 0
  alone inside the group (a loss issues no collective of its own).
"""

import sys

import numpy as np
import torch

CLASS_WEIGHTS = (0.3, 1.7)


def weighted_ce(data, rows, out, rank, world):
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.train.trainer import (create_optimizer,
                                              make_eval_step,
                                              make_train_step,
                                              validation_loss)
    loss_fn = create_loss_function('ce', class_weights=CLASS_WEIGHTS)
    imgs = rows(data['imgs']).permute(0, 3, 1, 2)[None]
    msks = rows(data['msks'])[None]

    def model_of(ds):
        model = create_model('attention_unet', base_features=8,
                             deep_supervision=bool(ds))
        model.load_state_dict(torch.load(f'{out}/weights_ds{ds}.pt'),
                              strict=True)
        return model.to(memory_format=torch.channels_last)

    result = {}
    for ds in (0, 1):
        model = model_of(ds)
        step = make_train_step(model, loss_fn,
                               create_optimizer(model, 1e-3), accum_steps=1)
        loss = step.accumulate(imgs, msks, [1.0])
        result[f'ds{ds}'] = {'loss': loss,
                             'grads': {k: p.grad.clone() for k, p in
                                       model.named_parameters()}}
    # a fresh model: the train forward moved the BatchNorm statistics
    eval_step = make_eval_step(model_of(0), loss_fn, 2, with_weights=True)
    n_val, batch = data['val_imgs'].shape[0], data['imgs'].shape[0]
    lb = batch // world
    losses = []
    for start in range(0, n_val, batch):
        idx = np.minimum(np.arange(start, start + batch), n_val - 1)
        real = min(max(min(batch, n_val - start) - rank * lb, 0), lb)
        w = torch.zeros(lb)
        w[:real] = 1.0
        loss, _ = eval_step(rows(data['val_imgs'][idx]).permute(0, 3, 1, 2),
                            rows(data['val_msks'][idx]), w)
        losses.append(loss)
    result['val_batch_losses'] = torch.stack(losses).clone()
    result['val_loss'] = validation_loss(losses)
    if rank == 0:
        with torch.inference_mode():
            result['alone'] = float(loss_fn(model_of(0).eval()(imgs[0]),
                                            msks[0]))
    return result


def main():
    coordinator, rank, world, out = sys.argv[1:5]
    mode = sys.argv[5] if len(sys.argv) > 5 else 'step'
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

    if mode == 'weighted_ce':
        torch.save(weighted_ce(data, rows, out, rank, world),
                   f'{out}/rank{rank}.pt')
        torch.distributed.destroy_process_group()
        return

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
