"""The port's FlowFormer with the published GSA sub-sampling
(``gsa_pad='valid'``) against the benchmark's plain reference
(``benchmark/reference/flowformer.py``, written from the published code, no
JAX), the reference against the JAX package's FlowFormer, and the deep ROI
step's spans.

Weights: seeded random weights in things.pth's state-dict layout
(``benchmark.reference.flowformer.synthetic_state``, the unused
``att.pos_emb`` and Twins ``norm`` tensors included; the flow head's last
convolution back at PyTorch's default, ten times the benchmark's, so that
three steps move the flow by pixels), loaded into the port
through ``load_flowformer_state`` and into the JAX model through its
``convert_flowformer``.  The things_eval widths throughout; three decoder
steps.  Frames 96×120: the Twins grids are 24×30 at sr 8 and 12×15 at sr 4,
so the published floor and the padded ceil sub-sampling differ (3×3 and 3×3
keys against 3×4 and 3×4); B = 2.  At 64×96 (16×24 and 8×12) both agree,
and there the reference is held to the JAX package, which cites the
published lines (the published code is not in the repository).

Measured here: the port within 3.5e-6 px of the reference (flows up to
1.9 px); under ``'same'`` 0.037 px away; the reference within 1.6e-6 px
of the JAX package (flows up to 1.9 px).
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import common
from benchmark.reference import flowformer as ref_ff
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.models.flowformer import FlowFormer, FlowFormerConfig
from nsof_tpu_torch.models.flowformer.convert import load_flowformer_state
from nsof_tpu_torch.models.flowformer.twins import GlobalSubSampleAttn, TwinsSVTLarge2Stage
from nsof_tpu_torch.pipelines import deep_flow as tdf
from nsof_tpu_torch.utils import timing
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

FLOW_TOL = 1e-4  # px: float32 against float32, different gathers and sums
STEPS = 3
H, W = 96, 120
CONFIG = common.read_json(common.ROOT / "benchmark" / "configs" / "flowformer.json")
MODEL = dict(CONFIG["model"], decoder_depth=STEPS)


def _state(seed, model):
    st = ref_ff.synthetic_state(seed, model)
    for leaf in ("weight", "bias"):
        st[f"{HEAD}.{leaf}"] = st[f"{HEAD}.{leaf}"] / ref_ff.FLOW_HEAD_SCALE
    return st


HEAD = "memory_decoder.update_block.flow_head.conv2"
STATE = _state(2**33 + 5, MODEL)
FIELDS = ("cnet", "fnet", "encoder_latent_dim", "query_latent_dim", "cost_latent_input_dim",
          "cost_latent_token_num", "cost_latent_dim", "cost_heads_num", "encoder_depth",
          "patch_size", "vert_c_dim", "cost_encoder_res", "decoder_depth", "add_flow_token",
          "use_gma", "only_global")


def _cfg(pad="valid", **kw):
    return FlowFormerConfig(**{k: MODEL[k] for k in FIELDS}, gsa_pad=pad, **kw)


def _port(pad="valid"):
    return load_flowformer_state(FlowFormer(_cfg(pad)), STATE).eval()


def _frames(b, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    base = (rng.random((b, h + 8, w + 8, 3)) * 255).astype(np.uint8)
    return (torch.from_numpy(np.ascontiguousarray(base[:, 4:4 + h, 4:4 + w])),
            torch.from_numpy(np.ascontiguousarray(base[:, 3:3 + h, 2:2 + w])))


@pytest.fixture(scope="module")
def flows():
    i1, i2 = _frames(2)
    out = {"ref": ref_ff.flowformer_flow(STATE, i1, i2, MODEL), "frames": (i1, i2)}
    with torch.no_grad():
        for pad in ("valid", "same"):
            out[pad] = _port(pad)(i1, i2, test_mode=True)
    return out


def test_valid_equals_the_published_reference(flows):
    ref = flows["ref"]
    assert ref.shape == (2, H, W, 2) and ref.abs().max() > 1.0
    assert (flows["valid"] - ref).abs().max() < FLOW_TOL


def test_same_is_not_the_published_model(flows):
    assert (flows["same"] - flows["ref"]).abs().max() > 100 * FLOW_TOL


def test_a_batch_of_two_is_two_batches_of_one(flows):
    i1, i2 = flows["frames"]
    model = _port()
    for b in (0, 1):
        one = ref_ff.flowformer_flow(STATE, i1[b:b + 1], i2[b:b + 1], MODEL)
        assert (one[0] - flows["ref"][b]).abs().max() < FLOW_TOL
        with torch.no_grad():
            got = model(i1[b:b + 1], i2[b:b + 1], test_mode=True)
        assert (got[0] - flows["valid"][b]).abs().max() < FLOW_TOL


def test_reference_matches_the_jax_package():
    """At 64×96, where 'same' and 'valid' keep the same keys: the reference
    against the JAX FlowFormer (one encoder layer, two steps: its compile
    time grows with both), through the JAX package's converter."""
    import jax

    from nsof_tpu.models.flowformer import config as jconfig
    from nsof_tpu.models.flowformer import model as jmodel
    from nsof_tpu.models.flowformer.convert import convert_flowformer

    model = dict(MODEL, encoder_depth=1, decoder_depth=2)
    state = _state(2**34 + 1, model)
    jcfg = jconfig.FlowFormerConfig(encoder_depth=1, decoder_depth=2)
    params = convert_flowformer({k: v.numpy() for k, v in state.items()}, jcfg)
    i1, i2 = _frames(1, 64, 96, seed=3)
    want = np.asarray(jax.jit(lambda p, a, b: jmodel.FlowFormer(jcfg).apply(
        {"params": p}, a, b, test_mode=True))(params, i1.numpy(), i2.numpy()))
    got = ref_ff.flowformer_flow(state, i1, i2, model).numpy()
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL)
    tcfg = {k: model[k] for k in FIELDS}
    with torch.no_grad():
        for pad in ("same", "valid"):
            port = load_flowformer_state(FlowFormer(FlowFormerConfig(**tcfg, gsa_pad=pad)),
                                         state).eval()
            np.testing.assert_allclose(port(i1, i2, test_mode=True).numpy(), want, rtol=0,
                                       atol=FLOW_TOL)


def test_valid_raises_on_a_side_shorter_than_sr():
    attn = GlobalSubSampleAttn(16, 2, 8, "valid")
    with pytest.raises(ValueError, match="no key"):
        attn(torch.zeros(1, 4, 16, 16))
    assert attn(torch.zeros(1, 8, 17, 16)).shape == (1, 8, 17, 16)
    assert GlobalSubSampleAttn(16, 2, 8)(torch.zeros(1, 4, 16, 16)).shape == (1, 4, 16, 16)
    with pytest.raises(ValueError, match="no key"):  # stage 1 of 24×64: a 6×16 grid at sr 8
        TwinsSVTLarge2Stage("valid")(torch.zeros(1, 24, 64, 3))
    with pytest.raises(ValueError, match="gsa_pad"):
        GlobalSubSampleAttn(16, 2, 8, "reflect")


# ── the deep ROI step ─────────────────────────────────────────────────────


def _step_config():
    """The flowformer configuration cut to 112×128 frames, a 96×112 window
    (Twins grids 24×28 and 12×14), memsize 48 (16-px cells, a 7×8 deep
    grid), three steps."""
    cfg = copy.deepcopy(CONFIG)
    cfg.update(image_h=112, image_w=128, window_h=96, window_w=112, model=MODEL)
    cfg["roi"]["memsize"] = 48
    keys = ("name", "image_h", "image_w", "roi", "fb", "head", "window_h", "window_w")
    return cfg, config_from_dict({k: cfg[k] for k in keys})


def _step_inputs():
    """Three samples: a block in the middle, one at the bottom-right corner
    (the window's origin clamped), one whose box is under 64 px."""
    prev, nxt = _frames(3, 112, 128, seed=1)
    mem = torch.zeros((3, 7, 8), dtype=torch.uint8)
    mem[0, 2:5, 2:5] = 255
    mem[1, 4:7, 5:8] = 255
    mem[2, 0, 0] = 255
    return mem, prev, nxt


@pytest.fixture(scope="module")
def deep_step():
    cfg, pcfg = _step_config()
    backend = tdf.DeepBackend.from_flowformer(_port(), device="cpu")
    args = _step_inputs()
    got = tdf.deep_roi_flow_batch(*args, pcfg, backend)
    want = ref_ff.roi_step(*args, cfg, STATE)
    return pcfg, backend, args, got, want


def test_deep_step_equals_the_reference_roi_step(deep_step):
    *_, got, want = deep_step
    assert want["any_active"].tolist() == [True, True, False]
    checks = common.seg_checks(got, want)
    assert checks["gate_rows"] == 0
    assert checks["flow_px"] < FLOW_TOL
    assert checks["mask_px"] == 0
    assert want["mask"][:2].flatten(1).any(dim=1).all()  # the masks are not empty


def _span_tree(prof) -> list:
    def tree(ev):
        out = []
        for c in sorted(ev.cpu_children, key=lambda e: e.time_range.start):
            if c.name.startswith("nsof."):
                out.append((c.name, tree(c)))
            else:
                out.extend(tree(c))
        return out

    roots = [e for e in prof.events() if e.cpu_parent is None]
    return tree(type("Root", (), {"cpu_children": roots})())


def test_deep_step_span_tree_and_outputs_under_the_profiler(deep_step):
    pcfg, backend, args, plain, _ = deep_step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = tdf.deep_roi_flow_batch(*args, pcfg, backend)
    for k in plain:
        assert torch.equal(plain[k], got[k]), k
    ff = ([("nsof.flowformer.encode", []), ("nsof.flowformer.memory", [])]
          + [("nsof.flowformer.lookup", []), ("nsof.flowformer.query", []),
             ("nsof.flowformer.update", [])] * STEPS
          + [("nsof.flowformer.upsample", [])])
    assert _span_tree(prof) == [("nsof.deep_roi_flow_batch", [
        ("nsof.gate", []), ("nsof.crop", []), ("nsof.deep.flow", ff), ("nsof.head", []),
        ("nsof.head", []), ("nsof.scatter", [])])]
    # inside the model's call, only views lie outside the FlowFormer spans,
    # and the one copy of the two active rows' flow into a zero window of 3
    flow = next(e for e in prof.events() if e.name == "nsof.deep.flow")
    outside = [c.name for c in flow.cpu_children if not c.name.startswith("nsof.")]
    copies = [c for c in outside if c in ("aten::zeros", "aten::index_copy_")]
    assert copies == ["aten::zeros", "aten::index_copy_"], outside
    assert set(outside) - set(copies) <= {"aten::select", "aten::slice", "aten::detach",
                                          "aten::alias"}, outside


def test_tracing_off_opens_no_range(deep_step, monkeypatch):
    pcfg, backend, args, plain, _ = deep_step

    def refuse(*a, **k):
        raise AssertionError("a record_function range was opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert timing.span("nsof.flowformer.update") is timing.span("nsof.gate")
    got = tdf.deep_roi_flow_batch(*args, pcfg, backend)
    assert all(torch.equal(plain[k], got[k]) for k in plain)


def test_train_mode_keeps_the_per_step_flows():
    """The split forward still gives the training path its list of flows,
    the last equal to test mode's."""
    model = _port()
    i1, i2 = _frames(1, 64, 96)
    with torch.no_grad():
        flows = model(i1, i2)
        assert len(flows) == STEPS
        torch.testing.assert_close(flows[-1], model(i1, i2, test_mode=True), rtol=0, atol=0)
