"""The ranks of tests/test_torch_port_pipeline.py: one process of a 4-rank
gloo group on the CPU, running the port's pipeline and expert parallelism
on the inputs the test wrote, and saving what it saw.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_pipeline_ranks.py <inputs.pt> <out_dir>

Imports torch and the port only (no JAX: the test holds the results to
the JAX package in its own process). A rank joins its group first, then
waits for ``<inputs.pt>`` (written by an atomic rename). Its results go to
``<out_dir>/rank<r>.pt``; the last cases run the prior's entry point under
the 4 ranks (the pipeline at 2 stages x 2 data rows, the experts at 4),
each resumed once at the same mesh.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dalle2_video_tpu_torch.models.moe import MoEFF, moe_sharding_tree  # noqa: E402
from dalle2_video_tpu_torch.models.prior import (  # noqa: E402
    DiffusionPrior,
    DiffusionPriorConfig,
    PriorNetworkConfig,
)
from dalle2_video_tpu_torch.parallel.collectives import ppermute  # noqa: E402
from dalle2_video_tpu_torch.parallel.mesh import (  # noqa: E402
    active_mesh,
    create_mesh,
    maybe_init_distributed,
)
from dalle2_video_tpu_torch.parallel.pipeline import pipeline_apply, stage_slices  # noqa: E402
from dalle2_video_tpu_torch.parallel.sharded import gather_whole, place_blocks  # noqa: E402
from dalle2_video_tpu_torch.train import train_prior  # noqa: E402
from dalle2_video_tpu_torch.train.ema import EMAConfig  # noqa: E402
from dalle2_video_tpu_torch.train.train_prior import PriorTrainer  # noqa: E402
from dalle2_video_tpu_torch.utils.keys import RowKeys  # noqa: E402
from dalle2_video_tpu_torch.weights import (  # noqa: E402
    load_prior_train_state_from_jax,
    params_from_jax,
)


def _t(a):
    return torch.as_tensor(a).clone()


def case_ppermute(inp, mesh14, out):
    r = mesh14.model_index
    x = _t(inp["ppermute"]["x"][r]).requires_grad_(True)
    y = ppermute(x, mesh14.model_group, 1)
    (y * _t(inp["ppermute"]["c"][r])).sum().backward()
    out["ppermute"] = (y.detach(), x.grad)


def _toy_layer(p, x, bias):
    return torch.tanh(x @ p["w"] + p["b"] + bias)


def case_toy(inp, meshes, out):
    """The JAX toy layer through pipeline_apply: M in {1, 2, 4} on (1, 4),
    and with batch_axis data, M = 2, on (2, 2); the whole stack held by
    every rank (stage_slices). Output and gradients of sum(out * c)."""
    toy = inp["toy"]
    got = {}
    for key, shape, m, batch_axis in (("m1", (1, 4), 1, None), ("m2", (1, 4), 2, None),
                                      ("m4", (1, 4), 4, None), ("dp", (2, 2), 2, "data")):
        mesh = meshes[shape]
        w, b, x, bias = (_t(toy[k]).requires_grad_(True) for k in ("w", "b", "x", "bias"))
        c, xs = _t(toy["c"]), x
        if batch_axis:  # this rank's rows of the data axis
            per = x.shape[0] // mesh.data
            rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
            xs, c = x[rows], c[rows]
        y = pipeline_apply(_toy_layer, stage_slices({"w": w, "b": b}, mesh), xs, mesh,
                           microbatches=m, batch_axis=batch_axis, broadcast_args=(bias,))
        (y * c).sum().backward()
        got[key] = {"out": y.detach(), "w": w.grad, "b": b.grad, "x": x.grad,
                    "bias": bias.grad}
    out["toy"] = got


def _prior(inp, name, mesh, **cfg):
    c = inp[name]
    return DiffusionPrior(DiffusionPriorConfig(network=PriorNetworkConfig(**c["net"]),
                                               timesteps=c["timesteps"],
                                               sample_timesteps=c["sample_timesteps"], **cfg),
                          device="cpu", mesh=mesh)


def _held(trainer):
    """This rank's parameters, moments and EMA shadow (blocks), and the
    whole gradients (gathered)."""
    net = trainer.prior.network
    st = trainer.optimizer.state
    return {"params": {k: p.detach().clone() for k, p in net.named_parameters()},
            "mu": {k: st[p]["exp_avg"].clone() for k, p in net.named_parameters()},
            "ema": {k: v.clone() for k, v in trainer.ema.params.items()},
            "grads": {k: trainer.whole(k, torch.zeros_like(p) if p.grad is None else p.grad)
                      for k, p in net.named_parameters()},
            "bytes": trainer.param_bytes()}


def case_prior(inp, name, mesh, out):
    """A placed prior (the pipeline on (1, 4), or the experts at EP 4) with
    the JAX training state loaded (each rank keeps its blocks): the network
    forward and the loss's gradients under the mesh."""
    c = inp[name]
    prior = _prior(inp, name, mesh.row())
    trainer = PriorTrainer(prior, 1e-3, use_ema=True, ema=EMAConfig(update_after_step=0))
    load_prior_train_state_from_jax(trainer, c["state"])
    net = prior.network
    with active_mesh(prior.mesh), torch.no_grad():
        fwd = net(_t(c["ve"]), _t(c["t"]).long(), text_embed=_t(c["te"]))
    net.train()
    with active_mesh(prior.mesh):
        loss = prior.loss(_t(c["ve"]), _t(c["te"]), draws=c["draws"])
        loss.backward()
    out[name] = dict(_held(trainer), out=fwd, loss=float(loss.detach()),
                     specs=dict(prior.specs))
    if name == "prior_pp":  # the pipelined DDIM loop under CFG (a doubled batch)
        s = c["sample"]
        with active_mesh(prior.mesh):
            out["sample"] = prior.sample_loop(RowKeys(list(range(len(s["te"])))), _t(s["te"]),
                                              cond_scale=2.0, init_noise=_t(s["x_t"]))


def case_moe(inp, mesh14, out):
    """MoEFF with one of 4 experts a rank: output, aux, gradients of
    sum(out * c) + aux (expert weights gathered)."""
    c = inp["moe"]
    m = MoEFF(c["dim"], c["experts"], mult=c["mult"], capacity_factor=c["cap"])
    m.load_state_dict(params_from_jax(c["params"]))
    specs = moe_sharding_tree(dict(m.named_parameters()), mesh14)
    place_blocks(m, specs, mesh14)
    x = _t(c["x"]).requires_grad_(True)
    with active_mesh(mesh14):
        y, aux = m(x)
        ((y * _t(c["c"])).sum() + aux).backward()
    out["moe"] = {"out": y.detach(), "aux": float(aux.detach()), "x": x.grad, "specs": specs,
                  "held": m.experts_w1.shape[0],
                  "grads": {k: gather_whole(p.grad, specs[k], mesh14)
                            for k, p in m.named_parameters()}}


def case_entry(inp, out):
    """The prior's entry point under the 4 ranks: the pipeline (2 stages x
    2 data rows) and the experts (EP 4), each trained, then resumed at the
    same mesh for one more epoch."""
    e = inp["entry"]
    for name, extra in e["runs"].items():
        args = [*e["args"], f"run_dir={e['dir']}/{name}", *extra]
        s = train_prior.main(args + ["prior.epochs=1"])
        s2 = train_prior.main(args + ["prior.epochs=2", "resume=true"])
        t = s2["trainer"]
        out[f"entry_{name}"] = {
            "steps": (s["trainer"].step, t.step), "mesh": (s2["mesh"].data, s2["mesh"].model),
            "losses": (s["train_loss"], s2["train_loss"], s2["val_loss"]),
            "params": {k: p.detach().clone() for k, p in t.prior.network.named_parameters()},
            "bytes": t.param_bytes(), "ema_bytes": sum(v.numel() * v.element_size()
                                                     for v in t.ema.params.values())}


def _wait_for(path: Path, seconds: float = 300.0) -> None:
    deadline = time.time() + seconds
    while not path.exists():
        if time.time() > deadline:
            raise TimeoutError(f"no inputs at {path} after {seconds} s")
        time.sleep(0.05)


def main(inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.WARNING)
    maybe_init_distributed(True, device="cpu")
    rank = dist.get_rank()
    meshes = {(d, m): create_mesh(d, m) for d, m in ((1, 4), (2, 2))}
    _wait_for(Path(inputs))
    inp = torch.load(inputs, weights_only=False)
    out = {"seconds": {}}
    clock = time.time()

    def timed(name, fn, *a):
        nonlocal clock
        fn(*a)
        out["seconds"][name] = time.time() - clock
        clock = time.time()

    timed("ppermute", case_ppermute, inp, meshes[1, 4], out)
    timed("toy", case_toy, inp, meshes, out)
    timed("prior_pp", case_prior, inp, "prior_pp", meshes[1, 4], out)
    timed("prior_ep", case_prior, inp, "prior_ep", meshes[1, 4], out)
    timed("moe", case_moe, inp, meshes[1, 4], out)
    timed("entry", case_entry, inp, out)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
