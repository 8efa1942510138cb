"""How far the JAX package's own flash and plain (xla) attention paths
disagree on a small UNet3D's gradients in bf16 compute -- the yardstick for
chip_smoke.py's bf16 module-gradient check, which holds the port's kernel
path (the flash kernel keeps f32 softmax state, as the Pallas kernel does)
to its plain path (bf16 products and softmax, as the JAX xla path).

    JAX_PLATFORMS=cpu python tests/measure_jax_flash_vs_xla_bf16_grads.py

Not a test (pytest does not collect it): the Pallas kernels run in
interpret mode on the CPU, about a minute a seed. The unet, inputs and
loss are chip_smoke.py's module-gradient check (dim 16, mults 1-2, 2 x 4 x
32 x 32 videos, the output conv redrawn from its zero init); bf16 casts of
f32 masters, as the trainer runs it. Prints the worst relative L2 error
over the parameter tensors for each seed.
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import dalle2_video_tpu.ops.pallas.flash_mqa as flash_mqa  # noqa: E402

# the modules call mqa_attention without interpret; on the CPU it must be
flash_mqa.mqa_attention = functools.partial(flash_mqa.mqa_attention, interpret=True)

from dalle2_video_tpu.models.unet3d import UNet3D, UNet3DConfig  # noqa: E402

KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=16, attn_dim_head=32,
          video_embed_dim=32, cond_on_video_embeds=True)


def worst_gap(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    target = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    ve = rng.standard_normal((2, 32)).astype(np.float32)
    t, keep = jnp.asarray([10, 700]), jnp.asarray([True, False])
    params = UNet3D(UNet3DConfig(**KW)).init(jax.random.PRNGKey(seed), jnp.asarray(x), t,
                                            video_embed=jnp.asarray(ve))
    k = params["params"]["to_out"]["Conv_0"]["kernel"]
    params["params"]["to_out"]["Conv_0"]["kernel"] = jnp.asarray(
        rng.uniform(-1, 1, k.shape).astype(np.float32) / np.sqrt(np.prod(k.shape[:-1])))
    grads = {}
    for impl in ("xla", "flash"):
        unet = UNet3D(UNet3DConfig(**KW, attention_impl=impl))

        def loss(p):
            pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
            out = unet.apply(pb, jnp.asarray(x, jnp.bfloat16), t,
                             video_embed=jnp.asarray(ve, jnp.bfloat16), video_keep_mask=keep)
            return jnp.mean((out.astype(jnp.float32) - target) ** 2)

        grads[impl] = jax.jit(jax.grad(loss))(params)
    errs = []
    for (path, gx), gf in zip(jax.tree_util.tree_flatten_with_path(grads["xla"])[0],
                              jax.tree_util.tree_leaves(grads["flash"])):
        gx, gf = np.asarray(gx, np.float64), np.asarray(gf, np.float64)
        errs.append((float(np.linalg.norm(gf - gx) / np.linalg.norm(gx)),
                     jax.tree_util.keystr(path)))
    return len(errs), max(errs)


if __name__ == "__main__":
    for seed in (0, 1):
        n, (err, name) = worst_gap(seed)
        print(f"seed {seed}: {n} tensors, worst relative L2 error flash vs xla {err:.3e} ({name})")
