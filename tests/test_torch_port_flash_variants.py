"""The flash probes' variants (table rows 10 and 11) against the JAX probe
kernels, on the CPU.

The port's wrappers run their plain versions for CPU tensors
(``ops/flash_variants.py``); the JAX side is the probes' own Pallas kernels
(scripts/perf_r3_probe8.py::r2_fwd, scripts/perf_r3_probe9.py::inner_fwd),
loaded with importlib (``scripts/`` is not a package) and run in interpret
mode: ``inner_fwd(interpret=True)``, and ``r2_fwd`` -- which takes no
interpret argument -- under ``pltpu.force_tpu_interpret_mode()``. Inputs come
from numpy with a fixed seed, at unaligned shapes with 64-key blocks.

Tolerances: f32 1e-5 (the same online softmax in f32, another summation
order). bf16 inputs 1e-2: both sides round the probabilities to bf16 for the
second product and the output once; a rounding flip moves an output of
O(1) by 2^-8.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dalle2_video_tpu_torch.ops import flash_variants as fv

torch.set_num_threads(1)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
B, N_Q, N_KV, D, BLOCK = 2, 100, 70, 32, 64
SCALE = D**-0.5
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the interpret-mode kernels compile at XLA's lowest optimisation level
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


_COMPILED = {}


def _run(jitted, *args, interpret_mode=False, **static):
    """The jitted probe function at O0, one compile per signature (the
    negative-logit case reuses the f32 ones)."""
    key = (jitted, interpret_mode, tuple((a.shape, str(a.dtype)) for a in args),
           tuple(sorted(static.items())))
    if key not in _COMPILED:
        lower = lambda: jitted.lower(*args, **static)
        if interpret_mode:  # r2_fwd takes no interpret argument
            with pltpu.force_tpu_interpret_mode():
                lowered = lower()
        else:
            lowered = lower()
        _COMPILED[key] = lowered.compile(compiler_options=_O0)
    return _COMPILED[key](*args)


def _probe(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probes():
    return _probe("perf_r3_probe8"), _probe("perf_r3_probe9")


def _inputs(seed, dtype, shift=0.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, n, D)).astype(np.float32) for n in (N_Q, N_KV, N_KV))
    k = k + np.float32(shift)
    j = [jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
         for a in (q, k, v)]
    t = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in j]
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r2_plain_matches_the_probe_kernel(probes, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(0, dtype)
    jqs = (jq.astype(jnp.float32) * SCALE).astype(jq.dtype)  # the caller scales q
    want = _run(probes[0].r2_fwd, jqs, jk, jv, interpret_mode=True, block_q=64, block_k=BLOCK)
    got = fv.r2_fwd((q.float() * SCALE).to(q.dtype), k, v, block_q=64, block_k=BLOCK)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inner,merge", [(2, "chain"), (2, "par"), (4, "chain"), (4, "par")])
def test_inner_plain_matches_the_probe_kernel(probes, dtype, inner, merge):
    (jq, jk, jv), (q, k, v) = _inputs(1, dtype)
    want = _run(probes[1].inner_fwd, jq, jk, jv, sm_scale=SCALE, block_q=64, block_k=BLOCK,
                inner=inner, merge=merge, interpret=True)
    got = fv.inner_fwd(q, k, v, sm_scale=SCALE, block_q=64, block_k=BLOCK,
                       inner=inner, merge=merge)
    _close(got, want, dtype)


def test_negative_logits_padded_zero_holds_the_max(probes):
    """Every real logit near -5 (above the -87 underflow): the zero-padded
    column holds the running max in both kernels, and both still give the
    exact softmax (f32)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, "float32")
    jq, q = jnp.abs(jq) * 0 + 1.0, torch.ones_like(q)
    jk, k = jk * 0.05 - 0.88, k * 0.05 - 0.88
    s = (q * SCALE) @ k.transpose(1, 2)
    assert float(s.max()) < -4.0 and float(s.min()) > -6.0
    exact = torch.softmax(s, -1) @ v
    want_r2 = _run(probes[0].r2_fwd, jq * SCALE, jk, jv, interpret_mode=True, block_q=64,
                   block_k=BLOCK)
    got_r2 = fv.r2_fwd(q * SCALE, k, v, block_k=BLOCK)
    want_in = _run(probes[1].inner_fwd, jq, jk, jv, sm_scale=SCALE, block_q=64,
                   block_k=BLOCK, inner=2, merge="par", interpret=True)
    got_in = fv.inner_fwd(q, k, v, sm_scale=SCALE, block_k=BLOCK, inner=2, merge="par")
    for got, want in ((got_r2, want_r2), (got_in, want_in)):
        _close(got, want, "float32")
        torch.testing.assert_close(got, exact, atol=1e-5, rtol=0)


def test_wrappers_are_forward_only_and_keep_their_kernel_records():
    q = torch.zeros(1, 4, D, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fv.r2_fwd(q, q, q)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fv.inner_fwd(q, q, q, sm_scale=1.0)
    with pytest.raises(ValueError, match="merge"):
        fv.inner_fwd(q.detach(), q.detach(), q.detach(), sm_scale=1.0, merge="tree")
    for kern, line in ((fv.R2_KERNEL, "scripts/perf_r3_probe8.py:94"),
                       (fv.INNER_KERNEL, "scripts/perf_r3_probe9.py:124")):
        assert kern.replaces == line and kern.launches == 0
        text = (SCRIPTS / line.split("/")[1].split(":")[0]).read_text().splitlines()
        assert text[int(line.split(":")[1]) - 1].startswith("def ")
