"""HTTP serving endpoint: the serving program behind a MicroBatcher.

Counterpart of ``anytime3d_tpu/serving/server.py``, with the same protocol
(JSON over HTTP, stdlib only on both ends):

  POST /infer   {"voxels_packed_b64": <base64 of N/8 uint8 bit-packed
                 occupancy>, "mask": [z_cat floats, optional]}
                (a float-input program takes {"input": [nested floats of
                 the item grid], "mask": ...} instead)
            ->  {"category": int, "z_mean": [...], "z_log_var": [...],
                 "pred_packed_b64": <base64 bits>}  (fields per program;
                 a float grid of more than 4096 values comes back as
                 "<key>_f32_b64", base64 of its float32 bytes)
  GET  /healthz ->  {"ok": true, "batches_run": int}

Start: python -m anytime3d_tpu_torch.cli.serve --config modelnet_nolbo --port 8731
   or: python -m anytime3d_tpu_torch.cli.serve --artifact model.pt2 --port 8731
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np
import torch

from anytime3d_tpu_torch.serving.batcher import MicroBatcher


class InferenceServer:
    """Owns the serving program's batcher; serves it over HTTP."""

    def __init__(
        self,
        infer_fn: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
        item_shape,
        mask_dim: int,
        batch_size: int = 8,
        max_wait_s: float = 0.002,
        device="cuda",
        input_dtype=np.uint8,
    ):
        """``infer_fn`` takes a batch of (B, *item_shape) items of
        ``input_dtype`` on ``device``: packed bits, uint8 (B, N/8), as
        ``make_packed_infer`` builds it, or float grids for a float-input
        program (``input_dtype=np.float32``)."""
        self.batcher = MicroBatcher(
            infer_fn,
            batch_size=batch_size,
            input_shape=tuple(item_shape),
            mask_dim=mask_dim,
            max_wait_s=max_wait_s,
            input_dtype=input_dtype,
            device=device,
        )
        self._item_shape = tuple(item_shape)
        self._dtype = input_dtype
        self._httpd: Optional[ThreadingHTTPServer] = None

    # ---- request handling ------------------------------------------------
    def infer_one(self, body: dict) -> dict:
        if "voxels_packed_b64" in body:
            x = np.frombuffer(base64.b64decode(body["voxels_packed_b64"]), np.uint8)
        else:
            if self._dtype == np.uint8:
                # a float grid cast to uint8 would truncate [0, 1] to zeros and
                # return a confident wrong prediction: fail the request
                raise ValueError("this server takes packed-bit input: send 'voxels_packed_b64' "
                                 "(np.packbits of the boolean grid), not raw 'input' floats")
            x = np.asarray(body["input"], np.float32)
        x = x.reshape(self._item_shape).astype(self._dtype)
        mask = np.asarray(body["mask"], np.float32) if body.get("mask") is not None else None
        out = self.batcher.submit(x, mask).result(timeout=300)
        resp = {}
        for k, v in out.items():
            v = np.asarray(v)
            if k.endswith("_packed"):
                resp[k + "_b64"] = base64.b64encode(v.tobytes()).decode()
            elif v.ndim == 0:
                resp[k] = v.item()
            elif v.size <= 4096:
                resp[k] = v.tolist()
            else:  # large float grids ride base64 of their raw bytes
                resp[k + "_f32_b64"] = base64.b64encode(v.astype(np.float32).tobytes()).decode()
        return resp

    # ---- HTTP plumbing ---------------------------------------------------
    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True, "batches_run": server.batcher.batches_run})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/infer":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    self._send(200, server.infer_one(body))
                except Exception as e:  # noqa: BLE001 — surface to client
                    self._send(400, {"error": repr(e)})

        return Handler

    def serve(self, port: int, background: bool = False, host: str = "127.0.0.1") -> int:
        """Bind and serve; returns the bound port (0 = ephemeral). Binds
        loopback by default: the endpoint is unauthenticated."""
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        bound = self._httpd.server_address[1]
        if background:
            threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        else:
            self._httpd.serve_forever()
        return bound

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.batcher.close()
