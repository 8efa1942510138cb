"""The port's serving path on the CPU at the smoke=true size: the engine
answers requests, a seed's video does not depend on its micro-batch, and
the HTTP handler answers POST /v1/generate. Plus the config and device
rules the entry point relies on."""

from __future__ import annotations

import base64
import http.client
import io
import json
import logging
import threading
from concurrent.futures import wait

import numpy as np
import pytest
import torch

from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
from dalle2_video_tpu_torch.serve.server import make_server
from dalle2_video_tpu_torch.serve.stack import apply_smoke, build_generate_batch
from dalle2_video_tpu_torch.utils.config import CELEBV_TEXT, config_from_argv, load_config
from dalle2_video_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def generate_batch():
    cfg = apply_smoke(load_config(None))
    return build_generate_batch(cfg, logging.getLogger("test"), device="cpu")


def test_engine_answers_requests(generate_batch):
    eng = GenerationEngine(generate_batch, buckets=(1, 2), max_wait_ms=50.0,
                           default_cond_scale=3.0, default_ddim_steps=3)
    try:
        futs = [eng.submit(GenRequest(p, seed=s, cond_scale=3.0, ddim_steps=3))
                for p, s in [("a smile", 1), ("a frown", 2), ("a nod", 3)]]
        done, _ = wait(futs, timeout=120)
        assert len(done) == 3
        for f in futs:
            v = f.result()["video"]
            assert v.shape == (2, 32, 32, 3)
            assert np.isfinite(v).all() and v.min() >= 0.0 and v.max() <= 1.0
        assert eng.stats()["requests"] == 3
    finally:
        eng.close()


def test_seed_video_independent_of_bucket(generate_batch):
    """Per-row generators: the same (prompt, seed) alone and as row 1 of a
    bucket of 2. f32 on the CPU; the batched convolutions may sum in
    another order, so 1e-5 instead of bit equality."""
    alone = generate_batch(["a smile"], [7], cond_scale=3.0, ddim_steps=3)
    pair = generate_batch(["a frown", "a smile"], [8, 7], cond_scale=3.0, ddim_steps=3)
    np.testing.assert_allclose(pair[1], alone[0], atol=1e-5)
    assert not np.allclose(pair[0], pair[1])


def test_max_batch_size_chunking_keeps_each_rows_video():
    """decoder.sample(max_batch_size=1) splits the batch; each row keeps its
    key, so the videos match the unchunked run (f32, 1e-5)."""
    from dalle2_video_tpu_torch.data.tokenizer import tokenize
    from dalle2_video_tpu_torch.serve.stack import build_stack
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    text_enc, wrapper = build_stack(apply_smoke(load_config(None)), "cpu")
    with torch.no_grad():
        embed = text_enc(torch.from_numpy(tokenize(["a", "b", "c"])))
    keys = RowKeys.from_request_seeds([1, 2, 3])
    whole = wrapper.generate(keys, embed, cond_scale=3.0, sample_timesteps=2)
    chunked = wrapper.generate(keys, embed, cond_scale=3.0, sample_timesteps=2,
                               max_batch_size=1)
    torch.testing.assert_close(chunked, whole, atol=1e-5, rtol=0)


def test_unported_request_options_fail_loudly(generate_batch):
    with pytest.raises(NotImplementedError):
        generate_batch(["x"], [0], cond_scale=1.0, ddim_steps=2, negative_prompts=["y"])


def test_http_generate_round_trip(generate_batch):
    eng = GenerationEngine(generate_batch, buckets=(1, 2), max_wait_ms=20.0,
                           default_cond_scale=3.0, default_ddim_steps=2)
    httpd = make_server(eng, "127.0.0.1", 0, device_name="cpu-test")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request("POST", "/v1/generate", json.dumps({"prompt": "a smile", "seed": 5}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        res = json.loads(resp.read())
        arr = np.load(io.BytesIO(base64.b64decode(res["data_b64"])))
        assert res["shape"] == [2, 32, 32, 3] and arr.shape == (2, 32, 32, 3)
        want = generate_batch(["a smile"], [5], cond_scale=3.0, ddim_steps=2)[0]
        np.testing.assert_allclose(arr, want, atol=1e-5)
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_builtin_config_equals_the_yaml():
    """CELEBV_TEXT mirrors configs/celebv_text.yaml (so the card, which has
    no YAML parser, serves the same settings)."""
    from pathlib import Path

    from dalle2_video_tpu.utils.config import load_config as jax_load

    yaml_path = str(Path(__file__).resolve().parents[1] / "configs" / "celebv_text.yaml")
    assert CELEBV_TEXT == jax_load(yaml_path)
    assert load_config(yaml_path) == CELEBV_TEXT


def test_config_overrides_reach_the_sampling_knobs():
    cfg = config_from_argv(["frame_numbers=[90,90]", "unet1.groupnorm_impl=pallas",
                            "unet2.cross_attention_impl=flash",
                            "flash_attention_sampling=true"])
    from dalle2_video_tpu_torch.engine.decoder import build_decoder

    cfg = dict(cfg, unet1=dict(cfg["unet1"], dim=8, dim_mults=[1, 2]),
               unet2=dict(cfg["unet2"], dim=8, dim_mults=[1, 2]))
    dec = build_decoder(cfg, device="cpu")
    assert dec.config.frame_numbers == (90, 90) and dec.config.flash_attention_sampling
    assert dec.unet_configs[0].groupnorm_impl == "pallas"
    assert dec.unet_configs[1].cross_attention_impl == "flash"
    assert dec.sampling_unet(0).mid_attn.impl == "flash"


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
