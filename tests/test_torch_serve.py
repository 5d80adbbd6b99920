"""vietasr_tpu_torch's AsrServer (serve/app.py) on an ephemeral port over
the port's Transcriber on the trained anchor (CPU, fp32); it mirrors
tests/test_serve.py and test_serve_streaming.py:

- GET /healthz and / (the port's own page, the websocket port filled in);
- POST /upload of a 16 kHz and an 8 kHz WAV (raw body and multipart): the
  transcript equals `Transcriber.transcribe` of the samples the server
  reads, and JAX's Transcriber on them;
- a long upload (past the last bucket, or past max_seconds) goes through
  `transcribe_long`, equal to JAX's;
- garbage, an empty body and unknown paths answer 400 / 404;
- the websocket path: a WAV message and its base64 form, and a real-time
  session on a StreamPool whose final text equals the pool driven
  directly with the same chunks.
"""

import asyncio
import base64
import io
import json
import os
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch
from test_torch_streaming_online import small_models

from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch.audio.io import read_wav, resample
from vietasr_tpu_torch.models.convert import load_anchor
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions
from vietasr_tpu_torch.serve import AsrServer
from vietasr_tpu_torch.serve.streams import StreamPool
from vietasr_tpu_torch.streaming_online import OnlineTranscriber

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")


def wav_bytes(samples: np.ndarray, sr: int = 16000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def transcribers():
    variables = load_anchor(ANCHOR)
    return (Transcriber(CONFIG, variables=variables, device="cpu",
                        options=TranscriberOptions(compute_dtype=None)),
            JaxTranscriber(CONFIG, variables=variables,
                           options=JaxOptions(compute_dtype=None)))


@pytest.fixture(scope="module")
def pool():
    _, _, cfg, variables = small_models("causal_per_feature",
                                        labels=("a", "b", "c", " "))
    return StreamPool(OnlineTranscriber(cfg, variables, device="cpu"),
                      slots=2, chunk_samples=3200)


@pytest.fixture(scope="module")
def server(transcribers, pool):
    s = AsrServer(transcribers[0], host="127.0.0.1", port=0,
                  stream_pool=pool).start(background=True)
    yield s
    s.stop()


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _post(server, data, ctype=None, path="/upload"):
    req = urllib.request.Request(_url(server, path), data=data,
                                 method="POST")
    if ctype:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req) as r:
        return json.load(r)


def _samples(data):
    samples, sr = read_wav(data)
    return samples if sr == 16000 else resample(samples, sr, 16000)


def test_ephemeral_ports_and_healthz(server):
    assert server.port > 0 and server.ws_port > 0
    with urllib.request.urlopen(_url(server, "/healthz")) as r:
        assert json.load(r)["status"] == "ok"


def test_index_served(server):
    with urllib.request.urlopen(_url(server, "/")) as r:
        page = r.read().decode()
    assert "vietasr_tpu_torch" in page
    assert str(server.ws_port) in page and "{{WS_PORT}}" not in page


@pytest.mark.parametrize("sr,seconds", [(16000, 1.3), (8000, 2.1)])
def test_upload_matches_transcribe(server, transcribers, sr, seconds):
    port, ref = transcribers
    rng = np.random.RandomState(sr // 1000)
    data = wav_bytes((rng.randn(int(sr * seconds)) * 0.1)
                     .astype(np.float32), sr)
    out = _post(server, data)
    samples = _samples(data)
    assert abs(out["duration"] - seconds) < 0.01
    assert out["transcript"] == port.transcribe(samples)
    assert out["transcript"] == ref.transcribe(samples)
    # the same file as multipart/form-data
    boundary = "xYzBoundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n"
            ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    multi = _post(server, body, f"multipart/form-data; boundary={boundary}")
    assert multi["transcript"] == out["transcript"]


def test_long_upload_goes_long_form(server, transcribers):
    port, ref = transcribers
    rng = np.random.RandomState(17)
    data = wav_bytes((rng.randn(18 * 16000) * 0.1).astype(np.float32))
    out = _post(server, data)
    samples = _samples(data)
    assert len(samples) > port.buckets[-1]
    assert out["transcript"] == port.transcribe_long(samples)
    assert out["transcript"] == ref.transcribe_long(samples)


def test_max_seconds_goes_long_form(transcribers, monkeypatch):
    port, _ = transcribers
    s = AsrServer(port, host="127.0.0.1", port=0, max_seconds=1.0)
    rng = np.random.RandomState(5)
    data = wav_bytes((rng.randn(int(1.5 * 16000)) * 0.1).astype(np.float32))
    calls = []
    long_form = port.transcribe_long

    def spy(x, **kw):
        calls.append(len(x))
        return long_form(x, **kw)

    monkeypatch.setattr(port, "transcribe_long", spy)
    out = s.transcribe_wav_bytes(data)
    assert calls == [len(_samples(data))]
    assert out["transcript"] == long_form(_samples(data))


def test_bad_requests(server):
    for data, path, code in ((b"not a wav", "/upload", 400),
                             (b"x", "/nowhere", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, data, path=path)
        assert e.value.code == code
    req = urllib.request.Request(_url(server, "/upload"), data=b"",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/missing"))
    assert e.value.code == 404


def test_websocket_upload_and_stream_session(server, transcribers, pool):
    import websockets

    port, _ = transcribers
    rng = np.random.RandomState(2)
    data = wav_bytes((rng.randn(8000) * 0.1).astype(np.float32))
    sig = (rng.randn(16000) * 0.1).astype(np.float32)
    pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
    url = f"ws://127.0.0.1:{server.ws_port}"

    async def run():
        async with websockets.connect(url) as ws:
            await ws.send(data)
            out1 = json.loads(await ws.recv())
            await ws.send(json.dumps(
                {"audio": base64.b64encode(data).decode()}))
            out2 = json.loads(await ws.recv())
        partials, final = [], None
        async with websockets.connect(url) as ws:
            await ws.send(json.dumps({"mode": "stream"}))
            assert json.loads(await ws.recv()).get("ready")
            raw = pcm.tobytes()
            for i in range(0, len(raw), 5000):      # uneven pieces
                await ws.send(raw[i:i + 5000])
            await ws.send(json.dumps({"type": "end"}))
            while final is None:
                msg = json.loads(await ws.recv())
                final = msg.get("final")
                if "partial" in msg:
                    partials.append(msg["partial"])
        return out1, out2, partials, final

    out1, out2, partials, final = asyncio.run(run())
    assert out1["transcript"] == out2["transcript"] \
        == port.transcribe(_samples(data))
    # the same audio through the pool directly: 5 chunks, then the flush
    slot = pool.open()
    direct = [pool.feed({slot: pcm[i:i + 3200]})[slot]
              for i in range(0, 16000, 3200)]
    direct += pool.flush(slot, return_pieces=True)
    assert pool.close(slot) == final
    assert partials == [p for p in direct if p]
