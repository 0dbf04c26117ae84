"""attention.device_share: the fused attention kernels' summed device
time in the traced window, forward and backward, as a share of the time
the card was busy there. None where none launched (a program or a
network without them)."""

from bench_h100.tracing import function_name

# the kernels ``F.scaled_dot_product_attention``'s fused backends launch
# for bf16 attention on the H100 (names as the trace gives them, before
# the template arguments): cuDNN's flash kernels, matched by the prefix
# its heuristics keep whichever tile and knob they pick, and their two
# helpers; flash-attention's kernels where PyTorch takes that backend
PREFIXES = ('cudnn_generated_fort_native_sdpa_sm90_flash_',)
KERNELS = (
    'compute_dot_do_o_specialized', 'convert_dq_to_16bits',
    'flash_fwd_kernel', 'flash_bwd_dot_do_o_kernel',
    'flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel',
    'flash_bwd_convert_dq_kernel')


def is_attention(op: str) -> bool:
    name = function_name(op)
    return name in KERNELS or name.startswith(PREFIXES)


def attention_kernels(trace):
    """(device seconds, launches) of the fused attention kernels."""
    hits = [op for op in trace.op_seconds if is_attention(op)]
    return (sum(trace.op_seconds[op] for op in hits),
            sum(trace.op_counts[op] for op in hits))


def read(layer, trace):
    if trace is None or layer.get('cell') != 'train' or not trace.busy_s:
        return None
    seconds, launches = attention_kernels(trace)
    if not launches:
        return None
    return 100.0 * seconds / trace.busy_s
