"""Closed loop of device-resident batches of RGB pairs through the port's
deep ROI step with FlowFormer: ``deep_roi_flow_batch`` on
``DeepBackend.from_flowformer``.

The traffic is ``deep_batch``'s (:func:`deep_batch.rgb_pairs`), so the two
deep cells see the same frames from the same seed.  Set-up builds the
model of the configuration's ``model`` block (``gsa_pad`` included: a port
without it fails at once) from weights drawn from the seed in the published
checkpoint's layout (``benchmark.reference.flowformer.synthetic_state``),
loaded through the port's ``load_flowformer_state``, the path a published
checkpoint takes; sets the precision the configuration states (cuDNN TF32
convolutions, float32 matrix products); draws ``params["batches"]`` batches
of ``params["batch"]`` RGB pairs onto the device and runs each once.  The
window then calls the step on them in turn, with no host synchronisation
between calls, until ``--seconds`` have passed, and ends in one
synchronisation.  With ``--trace 1`` ``params["trace_calls"]`` more calls run
under the profiler.  ``counters`` holds the kernel wrappers' launches a call
in the window (``_build.LAUNCHES``).

The check takes the last call's output, every row of it, and compares it
with the reference (``benchmark.reference.flowformer.roi_step``, float32)
on the same inputs and weights in blocks of ``params["check_block"]`` rows.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark import common
from benchmark.reference import flowformer as ref_ff
from benchmark.trace import traced
from benchmark.traffic.deep_batch import OUT_KEYS, make_batches, rgb_pairs

# the configuration's model keys the port's FlowFormerConfig takes
FIELDS = ("cnet", "fnet", "encoder_latent_dim", "query_latent_dim", "cost_latent_input_dim",
          "cost_latent_token_num", "cost_latent_dim", "cost_heads_num", "encoder_depth",
          "patch_size", "vert_c_dim", "cost_encoder_res", "decoder_depth", "add_flow_token",
          "use_gma", "only_global", "gsa_pad")


def ff_config(cell):
    """The port's ``FlowFormerConfig`` of the configuration's ``model`` block."""
    from nsof_tpu_torch.models.flowformer import FlowFormerConfig

    m = cell.config["model"]
    return FlowFormerConfig(**{k: m[k] for k in FIELDS})


def entry(cell, state):
    """The timed call: ``deep_roi_flow_batch`` on one batch ``(mem, prev,
    nxt)``, FlowFormer from ``state`` bound to the cell's device."""
    from nsof_tpu_torch.models.flowformer import FlowFormer
    from nsof_tpu_torch.models.flowformer.convert import load_flowformer_state
    from nsof_tpu_torch.pipelines.deep_flow import DeepBackend, deep_roi_flow_batch

    model = load_flowformer_state(FlowFormer(ff_config(cell)), state)
    backend = DeepBackend.from_flowformer(model, device=cell.device)
    cfg = cell.pipeline_config()

    def call(batch):
        return deep_roi_flow_batch(*batch, cfg, backend)
    return call


def check(cell, batch, out, state, dt=None) -> dict:
    """Every row of ``out`` against the reference on ``batch``, in blocks;
    the worst of each number over the blocks.  With ``dt`` the reference
    in that arithmetic stands in for ``out``."""
    blk = cell.params["check_block"]
    st = {k: v.to(cell.device) for k, v in state.items()}
    checks, active, masked, flow_max = {}, 0, 0, 0.0
    for s in range(0, batch[0].shape[0], blk):
        rows = [x[s : s + blk] for x in batch]
        want = ref_ff.roi_step(*rows, cell.config, st)
        got = ({k: out[k][s : s + blk] for k in OUT_KEYS} if dt is None
               else ref_ff.roi_step(*rows, cell.config, st, dt))
        common.merge_worst(checks, common.seg_checks(got, want))
        active += int(want["any_active"].sum())
        masked += int((want["mask"].flatten(1).any(dim=1) & want["any_active"]).sum())
        flow_max = max(flow_max, float(want["flow"].abs().max()))
        del want, got
    print(f"deep_batch_ff: {masked} of the reference's {active} active rows have a non-empty "
          f"mask; its largest flow component {flow_max:.4f} px", file=sys.stderr)
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return checks


def run(cell) -> dict:
    from nsof_tpu_torch import _build

    ff_config(cell)  # a port without this configuration's options fails here, at once
    sync = torch.cuda.synchronize if cell.device.type == "cuda" else (lambda: None)
    # the configuration's precision, PyTorch's defaults set explicitly: TF32
    # convolutions in cuDNN, float32 matrix products in cuBLAS
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    state = ref_ff.synthetic_state(cell.seed, cell.config["model"])
    call = entry(cell, state)
    batches = make_batches(cell)
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    for b in batches:  # warm-up: every shape the window uses
        out = call(b)
    del out
    sync()
    setup_end = time.time()
    _build.reset_launches()
    k, n, out = len(batches), 0, None
    t0 = time.perf_counter()
    while True:
        out = call(batches[n % k])
        n += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    counters = {name: v / n for name, v in _build.LAUNCHES.items() if v}
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    last = (n - 1) % k
    pairs = n * cell.params["batch"]
    trace, traced_pairs = None, 0
    if cell.trace:
        calls = cell.params["trace_calls"]
        with traced(cell.scratch / f"{cell.name}.trace.json", with_stack=True) as got:
            for j in range(calls):
                out = call(batches[(n + j) % k])
        trace, last = got[0], (n + calls - 1) % k
        traced_pairs = calls * cell.params["batch"]
    batch = batches[last]
    del batches
    checks = check(cell, batch, out, state)
    return {
        "setup_end": setup_end,
        "metrics": {"pairs_per_s": pairs / elapsed, "peak_mem_gib": peak / common.GIB},
        "memory_peak_bytes": peak,
        "attempted": pairs,
        "failed": 0,
        "checks": checks,
        "trace": trace,
        "traced_pairs": traced_pairs,
        "host": {"pairs_per_s": pairs / elapsed},
        "counters": counters,
    }


def control(cell) -> dict:
    """The reference one precision lower (the model under bfloat16
    autocast) in the program's place, on the cell's first batch, compared
    as :func:`run` compares the program."""
    batch = rgb_pairs(cell.seed, cell.config, cell.params, cell.params["batch"], cell.device,
                      salt=0)
    state = ref_ff.synthetic_state(cell.seed, cell.config["model"])
    return check(cell, batch, None, state, dt=torch.bfloat16)
