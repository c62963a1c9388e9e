"""The port's checkpoint loaders (``nsof_tpu_torch/models/convert.py``,
``nsof_tpu_torch/models/flowformer/convert.py``) against the JAX
package's, on synthetic checkpoints in the reference's format: no
published checkpoint is in the repository.

- RAFT-basic as ``raft-things.pth`` holds it: ``module.``-prefixed keys, a
  BatchNorm2d cnet (weight, bias, running statistics,
  ``num_batches_tracked``, the downsampling norms under both their names),
  instance-norm fnet.  ``pretrained_raft`` folds the BatchNorms into the
  ``'frozenbatch'`` affine; the JAX ``pretrained_raft`` reads the same
  file; the two flows agree within 1e-3 px, and the folded affine is
  BatchNorm's eval-mode output.
- RAFT-small as ``raft-small.pth``: the config is inferred (radius 3).
- FlowFormer as ``things.pth`` at reduced depth, with the tensors the model
  never uses (GMA's ``att.pos_emb``, the Twins wrapper's ``svt.norm``)
  dropped on load; against the JAX ``pretrained_flowformer``.
- Strictness: a missing, an extra or a misshapen tensor raises
  ``ValueError`` naming it; so does a Flax tree with a stray parameter.

Measured here: RAFT-basic 5.7e-7 px, RAFT-small 7.5e-6 px and FlowFormer
1.9e-6 px from the JAX loaders' models (flows up to 0.44, 0.95 and 2.6 px:
torch's default initialisation).
"""

import jax
import numpy as np
import pytest
import torch

from nsof_tpu.models.convert import pretrained_raft as jax_pretrained_raft
from nsof_tpu.models.flowformer.config import FlowFormerConfig as JFFConfig
from nsof_tpu.models.flowformer.convert import pretrained_flowformer as jax_pretrained_ff
from nsof_tpu_torch.models import raft as traft
from nsof_tpu_torch.models.convert import (NORM_EPS, params_from_jax, pretrained_raft)
from nsof_tpu_torch.models.flowformer import FlowFormer, FlowFormerConfig
from nsof_tpu_torch.models.flowformer.convert import pretrained_flowformer
from tests.torch_deep_weights import frame_pair, raft_params
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

FLOW_TOL = 1e-3  # px
ITERS = 2
REDUCED = dict(encoder_depth=1, decoder_depth=2)


def _reference_raft_state(small: bool, seed: int = 0) -> dict:
    """A random RAFT state_dict in the reference checkpoint's format: the
    basic model's cnet norms as BatchNorm2d, keys under ``module.``."""
    gen = torch.Generator().manual_seed(seed)
    cfg = traft.RaftConfig(small=small, corr_radius=3 if small else 4,
                           cnet_norm="batch" if small else "frozenbatch")
    model = traft.RAFT(cfg)
    modules = dict(model.named_modules(remove_duplicate=False))
    made, state = {}, {}
    for key, val in model.state_dict().items():
        mod = key.rsplit(".", 1)[0]
        norm = modules[mod]
        if not isinstance(norm, traft.AffineNorm):
            state[key] = val
            continue
        # one BatchNorm's tensors under each of its names (normN, downsample.1)
        if id(norm) not in made:
            c = val.shape[0]
            made[id(norm)] = {"weight": 1 + 0.2 * torch.randn(c, generator=gen),
                              "bias": 0.2 * torch.randn(c, generator=gen),
                              "running_mean": 0.3 * torch.randn(c, generator=gen),
                              "running_var": 0.5 + torch.rand(c, generator=gen),
                              "num_batches_tracked": torch.tensor(1000)}
        state.update({f"{mod}.{n}": t for n, t in made[id(norm)].items()})
    return {f"module.{k}": v for k, v in state.items()}


@pytest.mark.parametrize("small", [False, True], ids=["basic", "small"])
def test_pretrained_raft_matches_jax_loader(small, tmp_path):
    path = tmp_path / ("raft-small.pth" if small else "raft-things.pth")
    state = _reference_raft_state(small)
    torch.save(state, path)
    model = pretrained_raft(str(path), iters=ITERS)
    assert model.cfg.small == small and model.cfg.corr_radius == (3 if small else 4)
    jmodel, variables = jax_pretrained_raft(str(path))
    a, b = frame_pair(1, 64, 96)
    _, want = jax.jit(lambda v, x, y: jmodel.apply(v, x, y, iters=ITERS, test_mode=True))(
        variables, a, b)
    with torch.no_grad():
        _, got = model(torch.from_numpy(a), torch.from_numpy(b), iters=ITERS, test_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FLOW_TOL)
    if not small:
        s = {k[len("module."):]: v for k, v in state.items()}
        scale = s["cnet.norm1.weight"].double() / torch.sqrt(
            s["cnet.norm1.running_var"].double() + NORM_EPS)
        torch.testing.assert_close(model.cnet.norm1.weight.double(), scale, rtol=1e-7, atol=0)
        x = torch.randn(2, 64, 5, 5, dtype=torch.float64)
        bn = torch.nn.BatchNorm2d(64, eps=NORM_EPS).double().eval()
        bn.load_state_dict({k.split(".")[-1]: v for k, v in s.items()
                            if k.startswith("cnet.norm1.")})
        torch.testing.assert_close(model.cnet.norm1.double()(x), bn(x), rtol=1e-6, atol=1e-6)


def _reference_ff_state(cfg) -> dict:
    torch.manual_seed(1)
    state = dict(FlowFormer(cfg).state_dict())
    state["memory_decoder.update_block.aggregator.gamma"] = torch.tensor([0.25])
    state["memory_decoder.att.pos_emb.rel_height.weight"] = torch.randn(15, 128)
    state["memory_decoder.att.pos_emb.rel_width.weight"] = torch.randn(15, 128)
    for enc in ("context_encoder", "memory_encoder.feat_encoder"):
        state[f"{enc}.svt.norm.weight"] = torch.ones(1024)
        state[f"{enc}.svt.norm.bias"] = torch.zeros(1024)
    return {f"module.{k}": v for k, v in state.items()}


def test_pretrained_flowformer_matches_jax_loader(tmp_path):
    path = tmp_path / "things.pth"
    torch.save(_reference_ff_state(FlowFormerConfig(**REDUCED)), path)
    model = pretrained_flowformer(str(path), FlowFormerConfig(**REDUCED))
    jmodel, variables = jax_pretrained_ff(str(path), JFFConfig(**REDUCED))
    a, b = frame_pair(1, 64, 96, seed=3)
    want = jax.jit(lambda v, x, y: jmodel.apply(v, x, y, test_mode=True))(variables, a, b)
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b), test_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FLOW_TOL)


def _mutations(state):
    """(name, broken state, expected message) for each kind of mismatch."""
    key = next(k for k in state if k.endswith("conv2.weight"))
    missing = dict(state)
    del missing[key]
    extra = dict(state, **{"module.fnet.stray.weight": torch.zeros(3)})
    misshapen = dict(state, **{key: torch.zeros(3, 3)})
    return [("missing", missing, "missing from the checkpoint"),
            ("extra", extra, "unused checkpoint tensor"),
            ("misshapen", misshapen, "shape")]


@pytest.mark.parametrize("which", ["raft", "flowformer"])
def test_loaders_are_strict(which, tmp_path):
    if which == "raft":
        state, load = _reference_raft_state(True), pretrained_raft
    else:
        state = _reference_ff_state(FlowFormerConfig(**REDUCED))

        def load(path):
            return pretrained_flowformer(path, FlowFormerConfig(**REDUCED))
    for name, broken, message in _mutations(state):
        path = tmp_path / f"{name}.pth"
        torch.save(broken, path)
        with pytest.raises(ValueError, match=message):
            load(str(path))


def test_params_from_jax_is_strict():
    from nsof_tpu.models.raft import RaftConfig as JRaftConfig

    params = raft_params(JRaftConfig(small=True, corr_radius=3))
    cfg = traft.RaftConfig(small=True, corr_radius=3)
    assert set(params_from_jax(params, cfg)) == set(traft.RAFT(cfg).state_dict())
    stray = dict(params, fnet=dict(params["fnet"], stray={"kernel": np.zeros((1, 1, 2, 2))}))
    with pytest.raises(ValueError, match="unused Flax parameter"):
        params_from_jax(stray, cfg)
    with pytest.raises(ValueError, match="no Flax source"):
        params_from_jax({k: v for k, v in params.items() if k != "cnet"}, cfg)
