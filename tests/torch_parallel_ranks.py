"""What each gloo rank of the port's parallel tests runs (``tests/torch_dist.py``
starts the ranks).  Each case builds its mesh with ``device='cpu'`` from the
launcher's variables, runs the port's parallel code, and rank 0 saves what
the test compares to ``out`` (an ``.npz``).  Inputs come in ``kwargs``, the
larger ones as files the test wrote.  Nothing here imports JAX."""

import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from nsof_tpu_torch.parallel import mesh as pmesh

WORLD = int(os.environ.get("WORLD_SIZE", 1))


def main(case: str, out: str, kwargs: dict) -> None:
    torch.set_num_threads(1)
    try:
        saved = CASES[case](**kwargs)
        if os.environ["RANK"] == "0":
            np.savez(out, **saved)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _gather0(x: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's ``x`` stacked in rank order (on every rank)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts).numpy()


def _raises(fn, exc) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"expected {exc.__name__}")


def mesh_shapes():
    m22 = pmesh.make_mesh(4, model_parallel=2, device="cpu")
    m41 = pmesh.make_mesh(4, device="cpu")
    m21 = pmesh.make_mesh(2, device="cpu")
    x = torch.arange(8)
    coords = torch.tensor([m22.get_local_rank("data"), m22.get_local_rank("model")])
    return {
        "shape_22": np.array(list(pmesh.mesh_shape(m22).values())),
        "shape_41": np.array(list(pmesh.mesh_shape(m41).values())),
        "ranks_22": m22.mesh.numpy(), "ranks_41": m41.mesh.numpy(),
        "ranks_21": m21.mesh.numpy(),
        "coords": _gather0(coords),
        "rows_22": _gather0(pmesh.local_rows(x, m22)),
        "rows_41": _gather0(pmesh.local_rows(x, m41)),
        "placements": np.array([repr(pmesh.data_sharding(m22)), repr(pmesh.replicated(m22))]),
        "too_many": np.array(_raises(lambda: pmesh.make_mesh(8, device="cpu"), ValueError)),
        "not_divisible": np.array(_raises(lambda: pmesh.make_mesh(4, model_parallel=3,
                                                                  device="cpu"), ValueError)),
        "rows_not_divisible": np.array(_raises(lambda: pmesh.local_rows(torch.arange(7), m22),
                                               ValueError)),
    }


def halo(n_rows: int, width: int, halo: int):
    from nsof_tpu_torch.parallel.spatial import halo_exchange_rows

    n = WORLD
    mesh = pmesh.init_mesh((n,), ("space",), device="cpu")
    x = torch.arange(n * n_rows * width, dtype=torch.float32).reshape(n * n_rows, width)
    got = halo_exchange_rows(pmesh.local_rows(x, mesh, "space"), halo, mesh.get_group("space"))
    # uint8 slabs of [rows, B, W] (the batch form's layout)
    x8 = (torch.arange(n * n_rows * 2 * width) % 251).to(torch.uint8).reshape(n * n_rows, 2,
                                                                                width)
    got8 = halo_exchange_rows(pmesh.local_rows(x8, mesh, "space"), halo,
                              mesh.get_group("space"))
    return {"got": _gather0(got), "x8": x8.numpy(), "got8": _gather0(got8)}


def seg(inputs: str, cfg: dict, radius: int, model_parallel: int):
    from nsof_tpu_torch.config import config_from_dict
    from nsof_tpu_torch.parallel.inference import make_sharded_seg_batch

    tcfg = config_from_dict(cfg)
    mesh = pmesh.make_mesh(model_parallel=model_parallel, device="cpu")
    with np.load(inputs) as z:
        mem, prev, nxt = z["mem"], z["prev"], z["next"]
    out = {}
    for mode in ("xla", "fused"):
        fn = make_sharded_seg_batch(mesh, tcfg, warp_radius=radius, kernel_mode=mode)
        got = fn(mem, prev, nxt)
        out.update({f"{mode}_{k}": v.numpy() for k, v in got.items()})
    out["any_active_dtype"] = np.array(str(got["any_active"].dtype))
    out["odd_batch"] = np.array(_raises(lambda: fn(mem[:-1], prev[:-1], nxt[:-1]), ValueError))
    return out


def spatial(inputs: str, params: list, halo: int):
    from nsof_tpu_torch.ops.farneback import FarnebackParams
    from nsof_tpu_torch.parallel.spatial import make_spatial_flow, make_spatial_flow_batch

    p = FarnebackParams(*params)
    with np.load(inputs) as z:
        prev, nxt, bprev, bnxt = z["prev"], z["next"], z["bprev"], z["bnext"]
    n = WORLD
    space = pmesh.init_mesh((n,), ("space",), device="cpu")
    grid = pmesh.init_mesh((2, n // 2), ("data", "space"), device="cpu")
    half = pmesh.init_mesh((n // 2,), ("space",), device="cpu") if n > 2 else None
    out = {"flow": make_spatial_flow(space, p, halo)(prev, nxt).numpy(),
           "batch": make_spatial_flow_batch(grid, p, halo)(bprev, bnxt).numpy()}
    if half is not None and half.get_coordinate() is not None:
        one = make_spatial_flow(half, p, halo)
        out["per_pair"] = np.stack([one(bprev[b], bnxt[b]).numpy() for b in range(2)])
    return out


def pipeline(inputs: str):
    from nsof_tpu_torch.models.raft import RaftConfig
    from nsof_tpu_torch.parallel.pipeline import (make_raft_pp_flow, pipeline_stages,
                                                  tied_stage_params)

    with np.load(inputs) as z:
        ws, bs, xs, scale = (torch.from_numpy(z[k]) for k in ("Ws", "bs", "xs", "scale"))
    n = WORLD
    stages = pmesh.init_mesh((n,), ("stage",), device="cpu")

    def stage_fn(params, const, act):
        w, b = params
        return torch.tanh(act @ w + b) * const

    out = {"out": pipeline_stages(stages, stage_fn, (ws, bs), xs, scale).numpy()}
    # a dict activation with two leaves
    two = pipeline_stages(stages, lambda p, c, a: {"a": a["a"] * p["w"], "b": a["b"] + a["a"]},
                          tied_stage_params({"w": torch.tensor(2.0)}, n),
                          {"a": xs, "b": torch.zeros_like(xs)})
    out.update(dict_a=two["a"].numpy(), dict_b=two["b"].numpy())
    # one stage: rank 0 alone
    single = pmesh.init_mesh((1,), ("stage",), device="cpu")
    if single.get_coordinate() is not None:
        out["single"] = pipeline_stages(single, lambda p, c, a: a * p["w"],
                                        tied_stage_params({"w": torch.tensor(2.0)}, 1),
                                        xs).numpy()
    three = pmesh.init_mesh((3,), ("stage",), device="cpu")
    out["not_divisible"] = np.array(_raises(
        lambda: make_raft_pp_flow(three, RaftConfig(small=True, iters=8)), ValueError))
    out["alternate"] = np.array(_raises(
        lambda: make_raft_pp_flow(three, RaftConfig(small=True, iters=9, corr_mode="alternate")),
        NotImplementedError))
    return out


def raft_pp(inputs: str, kinds: list, iters: int):
    from nsof_tpu_torch.models.raft import RAFT, RaftConfig
    from nsof_tpu_torch.parallel.pipeline import make_raft_pp_flow

    stages = pmesh.init_mesh((WORLD,), ("stage",), device="cpu")
    out = {}
    with np.load(inputs) as z:
        img1, img2 = z["img1"], z["img2"]
    for kind in kinds:
        cfg = RaftConfig(small=kind == "small", iters=iters)
        model = RAFT(cfg)
        model.load_state_dict(torch.load(f"{inputs}.{kind}.pt", weights_only=True))
        model.eval()
        out[kind] = make_raft_pp_flow(stages, cfg)(model, img1, img2).numpy()
    return out


def _gather_full(state, named: dict) -> dict:
    """name → tensor (a gradient or a parameter) with tp shards gathered."""
    from nsof_tpu_torch.parallel.train import _GatherFromModel, _sharded_names

    sharded = _sharded_names(state.model)
    with torch.no_grad():
        return {n: (_GatherFromModel.apply(t, 0, sharded[n].group) if n in sharded else t)
                .numpy() for n, t in named.items()}


def train_raft(weights: str, batch: str, cfg: dict, dp: int, tp: int, lr: float,
               num_steps: int, iters: int, ckpt: str):
    """One dp×tp RAFT step from the given weights: the loss and metrics, the
    gradients the clip saw (summed over 'data'), the clip's norm and the
    updated parameters, each gathered to the one-device layout; then the
    state saved as step 1 of ``ckpt`` and restored into a fresh state on the
    mesh, whose shards (parameters and AdamW moments) must equal the saved
    state's bit for bit on every rank."""
    from nsof_tpu_torch.models.raft import RaftConfig
    from nsof_tpu_torch.parallel import train as ptrain
    from nsof_tpu_torch.train import optim
    from nsof_tpu_torch.train.trainer import restore_checkpoint, save_checkpoint

    mesh = pmesh.make_mesh(dp * tp, model_parallel=tp, device="cpu")
    model, tx, state = ptrain.create_train_state(0, mesh, cfg=RaftConfig(**cfg), lr=lr,
                                                 num_steps=num_steps)
    full = torch.load(weights, weights_only=True)
    ptrain.load_full_state_dict(state, {"model": full, "tx": tx.state_dict()})
    seen = {}
    clip = optim.clip_grad_global_norm_

    def spy(params, max_norm, sharded=(), group=None):
        seen["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        seen["norm"] = clip(params, max_norm, sharded, group)
        return seen["norm"]

    optim.clip_grad_global_norm_ = spy
    with np.load(batch) as z:
        b = dict(z)
    state, metrics = ptrain.make_train_step(model, tx, mesh, iters=iters)(state, b)
    optim.clip_grad_global_norm_ = clip
    grads = _gather_full(state, seen["grads"])
    params = _gather_full(state, dict(model.named_parameters()))
    n_sharded = len(ptrain._sharded_names(model))
    save_checkpoint(ckpt, 1, state)
    _, fresh_tx, fresh = ptrain.create_train_state(1, mesh, cfg=RaftConfig(**cfg), lr=lr,
                                                   num_steps=num_steps)
    fresh, step = restore_checkpoint(ckpt, fresh)
    moments = lambda t: [v for s in t.optimizer.state.values()  # noqa: E731
                         for k, v in sorted(s.items()) if k != "step"]
    same = step == 1 and all(torch.equal(a, b) for a, b in zip(
        list(fresh.params.values()) + moments(fresh_tx),
        list(state.params.values()) + moments(tx)))
    return {"metrics": np.array(json.dumps({k: float(v) for k, v in metrics.items()})),
            "norm": seen["norm"].numpy(), "n_sharded": np.array(n_sharded),
            "restored_equal": _gather0(torch.tensor(same)),
            **{f"grad/{n}": g for n, g in grads.items()},
            **{f"param/{n}": p for n, p in params.items()}}


def train_flowformer(weights: str, batch: str, cfg: dict, opt: dict):
    """One dp FlowFormer step from the given weights."""
    from nsof_tpu_torch.models.flowformer import config as tconfig
    from nsof_tpu_torch.parallel import train as ptrain

    mesh = pmesh.make_mesh(device="cpu")
    model, tx, state = ptrain.create_flowformer_state(0, mesh, cfg=tconfig.FlowFormerConfig(**cfg),
                                                      **opt)
    model.load_state_dict(torch.load(weights, weights_only=True))
    with np.load(batch) as z:
        b = dict(z)
    state, metrics = ptrain.make_flowformer_step(model, tx, mesh)(state, b)
    return {"metrics": np.array(json.dumps({k: float(v) for k, v in metrics.items()})),
            **{f"param/{n}": p.detach().numpy() for n, p in model.named_parameters()}}


def cli_train(data_root: str, ckpt_root: str, mesh: str, crop: list, batch_size: int):
    """``train --mesh`` through the CLI's ``main``, the chairs stage cut to
    ``crop`` and ``batch_size``."""
    from nsof_tpu_torch import cli
    from nsof_tpu_torch.train import curriculum

    curriculum.RAFT_STANDARD_STAGES = tuple(
        dataclasses.replace(s, image_size=tuple(crop), batch_size=batch_size)
        for s in curriculum.RAFT_STANDARD_STAGES)
    rc = cli.main(["train", "--data-root", data_root, "--ckpt-root", ckpt_root, "--mesh", mesh,
                   "--stage", "chairs", "--small", "--steps", "1", "--device", "cpu"])
    # the CLI destroyed its process group; the checkpoint is the result
    return {"rc": np.array(rc)}


CASES = {
    "mesh_shapes": mesh_shapes,
    "halo": halo,
    "seg": seg,
    "spatial": spatial,
    "pipeline": pipeline,
    "raft_pp": raft_pp,
    "train_raft": train_raft,
    "train_flowformer": train_flowformer,
    "cli_train": cli_train,
}
