"""How many bf16 values of the port's plain GroupNorm -> FiLM -> SiLU (row 3's
plain version, forward and dx through its autograd) differ from the JAX
Pallas kernel in interpret mode on the same bf16 inputs (CPU).

    JAX_PLATFORMS=cpu python tests/measure_gn_shares_vs_jax.py [--root DIR]

``--root`` (default: this checkout) puts another checkout's port first on
the import path (a parent commit unpacked beside this one); the JAX side is
this checkout's. The cases are those of
``tests/test_torch_port_kernels.py`` (``_gn_bf16_inputs``: x = 2 randn +
0.5, or 30 + randn for "bf16-mean30"; C = 64, L = 512, 8 groups, the JAX
kernel at block_l 64): per case the share of forward outputs and of dx
values that differ, and the largest difference in bf16 steps of the larger
value (at no less than 2^-8 of its channel's largest |value|).
"""

from __future__ import annotations

import argparse
import inspect
import sys
from pathlib import Path

import numpy as np

CASES = ("bf16", "bf16-mean30")
B, L, C, GROUPS, BLOCK_L = 2, 512, 64, 8, 64
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _bf16(a):
    import torch

    return torch.from_numpy(a).bfloat16().float().numpy()


def inputs(kind: str, seed: int, grad_seed: int):
    """x and the FiLM parameters rounded to bf16 (f32 arrays), and g."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    x = x + 30.0 if kind == "bf16-mean30" else x * 2.0 + 0.5
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = [_bf16(a) for a in (x, draw(C) * 0.1 + 1.0, draw(C) * 0.1,
                               draw(B, C) * 0.1, draw(B, C) * 0.1)]
    g = _bf16(np.random.default_rng(grad_seed).standard_normal((B, L, C)).astype(np.float32))
    return args, g


def steps(got, want) -> float:
    floor = 2.0**-8 * np.abs(want).max(1, keepdims=True)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor)
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float((np.abs(got - want) / ulp).max())


def measure(kind: str, port_gn) -> dict:
    """Forward and dx shares of one case, with the test file's seeds."""
    import jax
    import jax.numpy as jnp
    import torch

    from dalle2_video_tpu.ops.pallas.groupnorm_film import groupnorm_film_silu as jax_gn

    def o0(fn, *a):
        return jax.jit(fn).lower(*a).compile(compiler_options=_O0)(*a)

    to_jax = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    # the port's plain version takes block_l where it follows the JAX order
    kw = ({"block_l": BLOCK_L}
          if "block_l" in inspect.signature(port_gn.groupnorm_film_reference).parameters else {})
    out = {}
    args, _ = inputs(kind, C + L, 0)
    want = np.asarray(o0(lambda *a: jax_gn(*a, GROUPS, 1e-5, BLOCK_L, True),
                         *[to_jax(a) for a in args]).astype(jnp.float32))
    got = port_gn.groupnorm_film_silu(*[tb(a) for a in args], groups=GROUPS, eps=1e-5,
                                      **kw).float().numpy()
    out["fwd_share"], out["fwd_steps"] = float((got != want).mean()), steps(got, want)
    args, g = inputs(kind, 30 + C + L, C + L)
    want = np.asarray(o0(jax.grad(lambda *a: jnp.sum(
        jax_gn(*a, GROUPS, 1e-5, BLOCK_L, True).astype(jnp.float32) * jnp.asarray(g))),
        *[to_jax(a) for a in args]).astype(jnp.float32))
    x = tb(args[0]).requires_grad_()
    y = port_gn.groupnorm_film_silu(x, *[tb(a) for a in args[1:]], groups=GROUPS, eps=1e-5,
                                    **kw)
    got = torch.autograd.grad(y, x, tb(g))[0].float().numpy()
    out["dx_share"], out["dx_steps"] = float((got != want).mean()), steps(got, want)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose port is measured (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import dalle2_video_tpu  # noqa: F401 -- the JAX side, this checkout's

    sys.path.insert(0, str(Path(args.root).resolve()))
    from dalle2_video_tpu_torch.ops import groupnorm_film as port_gn

    print(f"port: {port_gn.__file__}")
    for kind in CASES:
        m = measure(kind, port_gn)
        print(f"{kind}: forward {100 * m['fwd_share']:.4f}% differ (max {m['fwd_steps']:.2f} "
              f"bf16 steps), dx {100 * m['dx_share']:.4f}% (max {m['dx_steps']:.2f} steps)")


if __name__ == "__main__":
    main()
