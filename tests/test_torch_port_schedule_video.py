"""The port's diffusion schedule, video ops and per-row keys against the JAX
package (and closed forms).

Tolerances: schedule buffers and the q/p algebra are float32 on both sides
from the same float64 numpy construction, so they agree to 1e-6 relative.
Nearest resizes are index gathers and must be bit-identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle2_video_tpu.diffusion.schedule import (
    DiffusionSchedule as JaxSchedule,
    make_beta_schedule as jax_betas,
)
from dalle2_video_tpu.ops import video as jax_video
from dalle2_video_tpu_torch.diffusion import DiffusionSchedule, make_beta_schedule
from dalle2_video_tpu_torch.ops import video as port_video
from dalle2_video_tpu_torch.utils.keys import RowKeys

torch.set_num_threads(1)

BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2",
)


@pytest.mark.parametrize("name", ["cosine", "linear", "quadratic", "jsd", "sqrt"])
def test_beta_schedules_match_jax(name):
    np.testing.assert_array_equal(make_beta_schedule(name, 1000), jax_betas(name, 1000))


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_schedule_buffers_match_jax(name):
    p, j = DiffusionSchedule.create(name, 1000), JaxSchedule.create(name, 1000)
    for buf in BUFFERS:
        np.testing.assert_allclose(getattr(p, buf).numpy(), np.asarray(getattr(j, buf)),
                                   rtol=1e-6, atol=0, err_msg=buf)


def test_schedule_closed_forms():
    """x0 -> (x_t, eps) round trips and the posterior mean of the DDPM
    paper: mu = coef1 * x0 + coef2 * x_t with the textbook coefficients."""
    s = DiffusionSchedule.create("cosine", 1000)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 3)).astype(np.float32))
    # t = 999 is left out: there 1/sqrt(alpha_bar) ~ 1e3 amplifies f32
    # rounding of x_t past any meaningful round-trip bound
    t = torch.tensor([0, 400, 900])
    xt = s.q_sample(x0, t, eps)
    torch.testing.assert_close(s.predict_start_from_noise(xt, t, eps), x0, atol=1e-4, rtol=0)
    torch.testing.assert_close(s.predict_noise_from_start(xt, t, x0), eps, atol=1e-3, rtol=0)
    v = s.calculate_v(x0, t, eps)
    torch.testing.assert_close(s.predict_start_from_v(xt, t, v), x0, atol=1e-4, rtol=0)
    beta = torch.from_numpy(make_beta_schedule("cosine", 1000))  # float64
    a = torch.cumprod(1 - beta, 0)
    a_prev = torch.cat([torch.ones(1, dtype=torch.float64), a[:-1]])
    c1 = beta * a_prev.sqrt() / (1 - a)
    c2 = (1 - a_prev) * (1 - beta).sqrt() / (1 - a)
    mean, var, _ = s.q_posterior(x0, xt, t)
    want = c1[t].reshape(3, 1, 1, 1, 1) * x0.double() + c2[t].reshape(3, 1, 1, 1, 1) * xt.double()
    torch.testing.assert_close(mean.double(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(var.reshape(3).double(),
                               (beta * (1 - a_prev) / (1 - a))[t], rtol=1e-5, atol=0)


def test_schedule_algebra_matches_jax():
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    xt = rng.standard_normal((2, 3, 4)).astype(np.float32)
    t = np.array([5, 700], np.int32)
    p, j = DiffusionSchedule.create("linear", 1000), JaxSchedule.create("linear", 1000)
    tt = torch.from_numpy(t).long()
    for name in ("predict_start_from_noise", "predict_noise_from_start",
                 "predict_start_from_v", "calculate_v", "q_sample"):
        got = getattr(p, name)(torch.from_numpy(xt), tt, torch.from_numpy(x0))
        want = getattr(j, name)(jnp.asarray(xt), jnp.asarray(t), jnp.asarray(x0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, w in zip(p.q_posterior(torch.from_numpy(x0), torch.from_numpy(xt), tt),
                    j.q_posterior(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- resizes
# every nearest resize of the 90-frame 64 -> 128 px cascade, plus the
# ratios where F.interpolate(mode="nearest") disagrees with jax.image.resize
SPATIAL = [(128, 64), (64, 128), (7, 3), (3, 7), (64, 64), (32, 128)]
TEMPORAL = [(90, 16), (16, 90), (90, 90), (7, 3), (3, 7), (2, 5)]


@pytest.mark.parametrize("h_in,h_out", SPATIAL)
def test_resize_video_nearest_matches_jax(h_in, h_out):
    rng = np.random.default_rng(h_in * 1000 + h_out)
    x = rng.random((2, 3, h_in, h_in, 3)).astype(np.float32) * 1.4 - 0.2
    want = jax_video.resize_video(jnp.asarray(x), h_out, clamp_range=(0.0, 1.0))
    got = port_video.resize_video(torch.from_numpy(x), h_out, clamp_range=(0.0, 1.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t_in,t_out", TEMPORAL)
def test_resize_video_time_matches_jax(t_in, t_out):
    """ops/video.py:69-81 resize_video_time, incl. 16 -> 90 frames."""
    rng = np.random.default_rng(t_in * 1000 + t_out)
    x = rng.standard_normal((2, t_in, 4, 4, 3)).astype(np.float32)
    want = jax_video.resize_video_time(jnp.asarray(x), t_out)
    got = port_video.resize_video_time(torch.from_numpy(x), t_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nearest_plain_mode_would_disagree():
    """Why nearest-exact: F.interpolate's legacy "nearest" picks other
    source pixels at 128 -> 64 (the decoder's downsample ratio)."""
    import torch.nn.functional as F

    x = torch.arange(128.0).reshape(1, 1, 1, 128)
    legacy = F.interpolate(x, size=(1, 64), mode="nearest")
    want = jax.image.resize(jnp.arange(128.0).reshape(1, 1, 1, 128), (1, 1, 1, 64), "nearest")
    assert not np.array_equal(legacy.numpy(), np.asarray(want))


def test_blur_and_pixel_shuffle_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 2, 8, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(
        port_video.gaussian_blur_video(torch.from_numpy(x), 3, 0.6).numpy(),
        np.asarray(jax_video.gaussian_blur_video(jnp.asarray(x), 3, 0.6)), atol=1e-6)
    np.testing.assert_array_equal(
        port_video.pixel_shuffle_spatial(torch.from_numpy(x)).numpy(),
        np.asarray(jax_video.pixel_shuffle_spatial(jnp.asarray(x))))
    np.testing.assert_array_equal(
        port_video.pixel_unshuffle_spatial(torch.from_numpy(x)).numpy(),
        np.asarray(jax_video.pixel_unshuffle_spatial(jnp.asarray(x))))


# -------------------------------------------------------------- row keys
def test_row_keys_draws_depend_only_on_the_row_seed():
    keys = RowKeys.from_request_seeds([5, 9, 5])
    x = keys.split()[0].normal((3, 4, 2), torch.device("cpu"))
    alone = RowKeys.from_request_seeds([9]).split()[0].normal((1, 4, 2), torch.device("cpu"))
    torch.testing.assert_close(x[1:2], alone, rtol=0, atol=0)
    torch.testing.assert_close(x[0], x[2], rtol=0, atol=0)
    assert not torch.equal(x[0], x[1])
    a, b = keys.split()
    assert a.seeds != b.seeds and keys.fold_in(0).seeds != a.seeds
    with pytest.raises(ValueError):
        keys.normal((2, 3), torch.device("cpu"))
