"""How many bf16 values of the port's plain tails differ from the jitted JAX
programs on the same bf16 weights and inputs (CPU).

    python tests/measure_bf16_tails_vs_jax.py [--root DIR]

``--root`` (default: this checkout) puts another checkout's port first on
the import path (a parent commit unpacked beside this one); the JAX side is
this checkout's. Cases: a plain (xla) Block3D with and without FiLM, a
ResnetBlock3D with its time MLP, the time conditioning (f32 sinusoids into
bf16 weights), and the activations the port's layers apply, against
``nn.silu`` / ``nn.gelu(approximate=False)``. Prints, per case, the share
of values that differ and the largest difference over the output's scale
(for the time conditioning: the output dtype beside JAX's).
``tests/test_torch_port_modules.py::test_bf16_plain_tails_match_jax_in_bf16``
holds the port to these cases.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

CASES = ("block3d", "block3d_film", "resnet_block", "time_cond", "silu", "gelu")
# the JAX references are jitted and compiled at XLA's lowest optimisation
# level: less compile time, the same arithmetic
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _o0(fn, *args):
    import jax

    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)(*args)


def _redraw(shapes, seed, std):
    import jax

    leaves, tree = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        tree, [(rng.standard_normal(l.shape) * std).astype(np.float32) for l in leaves])


def run_case(case: str):
    """(port output, JAX output) of one case, as numpy arrays: f32 copies of
    the bf16 outputs, or the f32 outputs of the time conditioning (a pair)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F

    from dalle2_video_tpu.models import layers as jl
    from dalle2_video_tpu_torch.models import layers
    from dalle2_video_tpu_torch.weights import load_from_jax

    rng = np.random.default_rng(4)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    if case in ("silu", "gelu"):
        x = (rng.standard_normal((64, 512)) * 3).astype(np.float32)
        jf = fnn.silu if case == "silu" else (lambda v: fnn.gelu(v, approximate=False))
        # the activation the port's layers apply at its sites
        tf = getattr(layers, f"{case}_as_jax", F.silu if case == "silu" else F.gelu)
        want = _o0(jf, bf(x)).astype(jnp.float32)
        return tf(tb(x)).float().numpy(), np.asarray(want)
    if case.startswith("block3d"):
        x = rng.standard_normal((2, 3, 8, 8, 32)).astype(np.float32)
        ss = (0.5 * rng.standard_normal((2, 2, 64))).astype(np.float32)
        jm, tm, seed, std = jl.Block3D(64, groups=8, norm_impl="xla"), \
            layers.Block3D(32, 64, 8, "xla"), 5, 0.5
        film = case == "block3d_film"
        jargs = (bf(x), tuple(bf(a) for a in ss) if film else None)
        targs = (tb(x), tuple(tb(a) for a in ss) if film else None)
        init = (jnp.asarray(x),)
    else:
        x = rng.standard_normal((2, 2, 8, 8, 32)).astype(np.float32)
        te = rng.standard_normal((2, 64)).astype(np.float32)
        time = np.array([3, 500], np.int32)
        seed, std = 6, 0.3
        if case == "resnet_block":  # the unet hands its blocks t in the activation dtype
            jm, tm = jl.ResnetBlock3D(64, time_cond_dim=64), \
                layers.ResnetBlock3D(32, 64, time_cond_dim=64)
            jargs, targs = (bf(x), bf(te)), (tb(x), tb(te))
        else:
            jm, tm = jl.TimeConditioning(16, 32, 64), layers.TimeConditioning(16, 32, 64)
            jargs, targs = (jnp.asarray(time),), (torch.from_numpy(time).long(),)
        init = jargs
    params = _redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *init), seed, std)
    want = _o0(jm.apply, jax.tree_util.tree_map(bf, params), *jargs)
    tm = load_from_jax(tm, params).to(torch.bfloat16)
    with torch.no_grad():
        got = tm(*targs)
    if case == "time_cond":
        return got, want
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose port is measured (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    torch.set_num_threads(1)
    from dalle2_video_tpu_torch.models import layers

    print(f"port: {layers.__file__}")
    for case in CASES:
        got, want = run_case(case)
        if case == "time_cond":
            for g, w in zip(got, want):
                w = np.asarray(w)
                err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
                print(f"{case}: port {g.dtype}, JAX {w.dtype}, max |diff| / scale {err:.2e}")
            continue
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"{case}: {np.mean(got != want):.4f} of values differ, max |diff| / scale "
              f"{err:.2e}")


if __name__ == "__main__":
    main()
