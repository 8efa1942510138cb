"""Flash-forward probe 9 (port of scripts/perf_r3_probe9.py): inner-kv
sub-tiles per step, chained or as independent partials, at the probe
geometry.

Rows:
  1. the control: the fused forward (``ops/flash_mqa.flash_mqa_fwd``, row 1);
  2. ``ops/flash_variants.inner_fwd`` with inner 2 / 4 x merge chain / par
     (row 11);
  3. ``wide2048``: the JAX probe's single 2048-key block of the fused
     forward. The port's row-1 kernel has one tile shape and takes no
     block_k, so this row is row 1 again, recorded as such;
  4. the library yardstick: SDPA with the kv expanded per head.

``--check`` runs the JAX probe's check_small instead: (2, 700, 515, 32) f32,
inner 2 / 4 x chain / par against exact softmax, max error < 1e-4 -- the
kernels on the card, the plain versions with ``--device cpu``.

    python -m dalle2_video_tpu_torch.probes.perf_r3_probe9 [--check] [--device cpu]
"""

from __future__ import annotations

from typing import Dict, List

import torch

from dalle2_video_tpu_torch.ops import flash_mqa as fm
from dalle2_video_tpu_torch.ops import flash_variants as fv
from dalle2_video_tpu_torch.probes import SCALE, inputs, main, run_rows, sdpa_row

VARIANTS = ((2, "chain"), (4, "chain"), (2, "par"), (4, "par"))


def rows(device, card: str) -> List[Dict]:
    q, k, v = inputs(device)
    control = dict(name="r3p9_control_fused", kind="fused forward (row 1)",
                   fn=lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=SCALE))
    inner = [dict(name=f"r3p9_inner{i}_{m}", kind=f"inner-kv {i} sub-tiles ({m}) (row 11)",
                  fn=lambda i=i, m=m: fv.inner_fwd(q, k, v, sm_scale=SCALE, inner=i, merge=m))
             for i, m in VARIANTS]
    wide = dict(name="r3p9_wide2048",
                kind="row 1 again: the port's fused forward has one tile shape (no block_k)",
                fn=lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=SCALE, block_k=2048))
    sdpa = dict(name="r3p9_sdpa", kind="library: SDPA, kv expanded per head",
                fn=sdpa_row(q, k, v))
    return run_rows([control, *inner, wide, sdpa], q, k, v, card)


def check_small(device) -> Dict[str, float]:
    """scripts/perf_r3_probe9.py::check_small: exactness against exact
    softmax at an unaligned small geometry. Returns the max error of each
    variant and raises if one reaches 1e-4."""
    b, n_q, n_kv, d = 2, 700, 515, 32
    q, k, v = inputs(device, torch.float32, seed=1, shape=(b, n_q, n_kv, d))
    scale = d**-0.5
    ref = fm.flash_mqa_reference(q, k, v, scale)
    errs = {}
    for inner, merge in ((2, "chain"), (2, "par"), (4, "chain"), (4, "par")):
        got = fv.inner_fwd(q, k, v, sm_scale=scale, block_q=128, block_k=128,
                           inner=inner, merge=merge)
        errs[f"inner{inner}_{merge}"] = err = float((got - ref).abs().max())
        print(f"check inner={inner} merge={merge}: max_err={err:.2e}", flush=True)
        if not err < 1e-4:
            raise AssertionError(f"inner={inner} merge={merge}: max error {err}")
    print(f"small-geometry checks OK ({device.type})", flush=True)
    return errs


if __name__ == "__main__":
    main("perf_r3_probe9", rows, check=check_small)
