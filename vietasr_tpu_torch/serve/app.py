"""Web demo and serving API (counterpart of vietasr_tpu/serve/app.py): the
reference's second entry point, a Flask + SocketIO demo, on the standard
library's HTTP server, plus a websocket microphone path where the
`websockets` package is installed.

Routes:
  GET  /            -> the demo page (serve/index.html)
  GET  /healthz     -> {"status": "ok"}
  POST /upload      -> body = WAV bytes (or multipart/form-data), returns
                       {"filepath", "transcript", "duration"}
  ws   :{ws_port}   -> each binary or base64 WAV message answers
                       {"transcript": ...}; a first message {"mode":
                       "stream", "encoding": "pcm16" | "ulaw"} opens a
                       real-time session on a StreamPool (partials, then
                       {"final": ...} after {"type": "end"})

Uploads are resampled to the model's rate; audio past the last bucket
(or past `max_seconds`) goes through `transcribe_long`. One forward runs
at a time (a lock around the Transcriber).
"""

from __future__ import annotations

import asyncio
import base64
import importlib.util
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from vietasr_tpu_torch.audio.io import read_wav, resample

_HTML_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "index.html")


class AsrServer:
    """`transcriber`: a pipeline.Transcriber (or anything with `cfg`,
    `buckets`, `transcribe` and `transcribe_long`). The websocket port is
    port + 1; `port=0` binds ephemeral ports for both (read `.port` and
    `.ws_port` after `start`)."""

    def __init__(self, transcriber, *, host: str = "0.0.0.0",
                 port: int = 5000, record_dir: Optional[str] = None,
                 max_seconds: float = 0.0, stream_pool=None):
        self.transcriber = transcriber
        self.host = host
        self.port = port
        self.ws_port = port + 1 if port else 0
        self.record_dir = record_dir
        self.max_seconds = max_seconds
        # an optional serve.streams.StreamPool for real-time sessions
        self.stream_pool = stream_pool
        if record_dir:
            os.makedirs(record_dir, exist_ok=True)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._ws_loop: Optional[asyncio.AbstractEventLoop] = None
        self._ws_ready = threading.Event()
        self._threads = []
        self._lock = threading.Lock()   # one forward at a time

    def transcribe_wav_bytes(self, data: bytes) -> dict:
        samples, sr = read_wav(data)
        target = self.transcriber.cfg.featurizer.sample_rate
        if sr != target:
            samples = resample(samples, sr, target)
        path = None
        if self.record_dir:
            path = os.path.join(self.record_dir,
                                f"{int(time.time() * 1000)}.wav")
            with open(path, "wb") as f:
                f.write(data)
        with self._lock:
            if (self.max_seconds and len(samples) > self.max_seconds * target
                    or len(samples) > self.transcriber.buckets[-1]):
                text = self.transcriber.transcribe_long(samples)
            else:
                text = self.transcriber.transcribe(samples)
        return {"filepath": path, "transcript": text,
                "duration": len(samples) / target}

    # -- HTTP ----------------------------------------------------------------

    def _make_handler(server):  # noqa: N805 — a closure over the server
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj: dict):
                self._send(code, json.dumps(obj, ensure_ascii=False).encode(),
                           "application/json; charset=utf-8")

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    with open(_HTML_PATH, "rb") as f:
                        body = f.read()
                    body = body.replace(b"{{WS_PORT}}",
                                        str(server.ws_port).encode())
                    self._send(200, body, "text/html; charset=utf-8")
                elif self.path == "/healthz":
                    self._json(200, {"status": "ok"})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/upload":
                    self._json(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._json(400, {"error": "empty body"})
                    return
                data = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("multipart/form-data"):
                    data = _extract_multipart_file(data, ctype)
                    if data is None:
                        self._json(400, {"error": "no file field"})
                        return
                try:
                    result = server.transcribe_wav_bytes(data)
                except Exception as e:  # noqa: BLE001 — report to client
                    self._json(400, {"error": f"decode failed: {e}"})
                    return
                self._json(200, result)

        return Handler

    # -- websocket (microphone) ----------------------------------------------

    async def _ws_handler(self, websocket):
        first = True
        async for message in websocket:
            try:
                if first and isinstance(message, str):
                    obj = json.loads(message)
                    if obj.get("mode") == "stream":
                        await self._stream_session(
                            websocket, obj.get("encoding", "pcm16"))
                        return
                first = False
                if isinstance(message, bytes):
                    data = message
                else:
                    data = base64.b64decode(json.loads(message)["audio"])
                result = await asyncio.get_event_loop().run_in_executor(
                    None, self.transcribe_wav_bytes, data)
                await websocket.send(json.dumps(result, ensure_ascii=False))
            except Exception as e:  # noqa: BLE001
                await websocket.send(json.dumps({"error": str(e)}))

    async def _stream_session(self, websocket, encoding: str = "pcm16"):
        """A real-time session: the client sends raw 16 kHz binary frames,
        PCM16 or 8-bit G.711 mu-law ({"encoding": "ulaw"} in the opening
        message), decoded on the device; the server answers {"partial":
        ...} per chunk and {"final": ...} after {"type": "end"}."""
        if self.stream_pool is None:
            await websocket.send(json.dumps(
                {"error": "streaming disabled; start the server with a "
                          "stream pool"}))
            return
        if encoding not in ("pcm16", "ulaw"):
            await websocket.send(json.dumps(
                {"error": f"unsupported encoding {encoding!r} "
                          "(pcm16 or ulaw)"}))
            return
        slot = self.stream_pool.open()
        if slot is None:
            await websocket.send(json.dumps({"error": "all stream slots "
                                             "busy"}))
            return
        loop = asyncio.get_event_loop()
        ulaw = encoding == "ulaw"
        bytes_per = 1 if ulaw else 2
        pad_byte = b"\xff" if ulaw else b"\x00"    # mu-law code for 0
        parse = (lambda b: np.frombuffer(b, np.uint8)) if ulaw \
            else (lambda b: np.frombuffer(b, "<i2"))
        chunk_bytes = self.stream_pool.chunk_samples * bytes_per

        async def feed(raw: bytes):
            out = await loop.run_in_executor(
                None, self.stream_pool.feed, {slot: parse(raw)})
            if out.get(slot):
                await websocket.send(json.dumps({"partial": out[slot]},
                                                ensure_ascii=False))

        buf = b""
        await websocket.send(json.dumps({"ready": True, "slot": slot}))
        try:
            async for message in websocket:
                if isinstance(message, str):
                    if json.loads(message).get("type") == "end":
                        break
                    continue
                buf += message
                while len(buf) >= chunk_bytes:
                    raw, buf = buf[:chunk_bytes], buf[chunk_bytes:]
                    await feed(raw)
            # flush: the padded last chunk, then the drain of the model's
            # lookahead; what surfaces there is still partial text
            if buf:
                await feed(buf + pad_byte * (chunk_bytes - len(buf)))
            pieces = await loop.run_in_executor(
                None, lambda: self.stream_pool.flush(slot,
                                                     return_pieces=True))
            for piece in pieces:
                if piece:
                    await websocket.send(json.dumps(
                        {"partial": piece}, ensure_ascii=False))
        finally:
            final = self.stream_pool.close(slot)
            try:
                await websocket.send(json.dumps({"final": final},
                                                ensure_ascii=False))
            except Exception:  # noqa: BLE001 — the client may have gone
                pass

    def _run_ws(self):
        import websockets

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._ws_stop = loop.create_future()

        async def main():
            async with websockets.serve(self._ws_handler, self.host,
                                        self.ws_port) as ws:
                self.ws_port = ws.sockets[0].getsockname()[1]
                self._ws_loop = loop
                self._ws_ready.set()
                await self._ws_stop

        try:
            loop.run_until_complete(main())
        finally:
            self._ws_ready.set()
            loop.close()

    # ------------------------------------------------------------------------

    def start(self, *, background: bool = False):
        """Bind and serve. The websocket path starts only where the
        `websockets` package is installed; the HTTP routes need nothing
        beyond the standard library."""
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        if importlib.util.find_spec("websockets") is not None:
            t = threading.Thread(target=self._run_ws, daemon=True)
            t.start()
            self._threads.append(t)
            self._ws_ready.wait(30)
        if background:
            t = threading.Thread(target=self._httpd.serve_forever,
                                 daemon=True)
            t.start()
            self._threads.append(t)
            return self
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        return self

    def stop(self):
        """Stop both servers and wait for their threads."""
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._ws_loop:
            self._ws_loop.call_soon_threadsafe(self._ws_stop.set_result, None)
            self._ws_loop = None
        for t in self._threads:
            t.join(10)
        self._threads = []


def _extract_multipart_file(data: bytes, content_type: str
                            ) -> Optional[bytes]:
    """Minimal multipart/form-data parser: the first file part's body."""
    marker = "boundary="
    idx = content_type.find(marker)
    if idx < 0:
        return None
    boundary = content_type[idx + len(marker):].strip().strip('"')
    for part in data.split(("--" + boundary).encode()):
        if b"filename=" not in part:
            continue
        header_end = part.find(b"\r\n\r\n")
        if header_end < 0:
            continue
        body = part[header_end + 4:]
        if body.endswith(b"\r\n"):
            body = body[:-2]
        return body
    return None


def serve(transcriber, **kwargs) -> AsrServer:
    """Start an AsrServer on `transcriber` (see AsrServer for kwargs) and
    serve until interrupted (or, with background=True, return it)."""
    background = kwargs.pop("background", False)
    server = AsrServer(transcriber, **kwargs)
    print(f"serving on http://{server.host}:{server.port} "
          f"(ws :{server.ws_port})")
    return server.start(background=background)
