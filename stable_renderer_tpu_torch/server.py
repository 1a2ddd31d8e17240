"""HTTP viewer + prompt server — the headless L6 surface.

Counterpart of stable_renderer_tpu/server.py, route for route. The
capability match for two reference pieces:

  * the PySide6 editor's live render view (reference: ui/main.py:23-160) —
    here a zero-dependency stdlib HTTP server that streams engine frames as
    MJPEG (`/stream`) plus single-frame (`/frame.png`) and a tiny HTML page
    (`/`), so any browser is the remote viewer of a GPU host;
  * the ComfyUI web server's prompt queue + history (reference:
    comfyUI/execution.py:1515-1617 PromptQueue put/get/task_done/history,
    main.run() server mode) — `PromptQueue` mirrors the mutex/condition
    queue + bounded history, and `POST /prompt` / `GET /history` /
    `GET /queue` expose it.

Threading model: the HTTP server runs daemon threads; the engine/executor
stays on its own thread and calls ``FrameServer.publish`` (a numpy uint8
frame) — publish never blocks the render loop (latest-frame mailbox, no
backpressure; stream clients drop frames they're too slow for). The worker
(``serve_workflows``) brings every tensor it hands on (previews, the final
frame) to the host as numpy first: the handler threads touch no CUDA tensor.
Executors run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import base64
import heapq
import io
import json
import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from stable_renderer_tpu_torch.utils.log import get_logger
from stable_renderer_tpu_torch.utils.paths import REPO_ROOT

logger = get_logger("sr_tpu_torch.server")

MAX_HISTORY = 10000  # execution.py PromptQueue history bound
WS_POLL_S = 0.05  # how long a websocket session waits on the event bus between client reads

# the reference's bundled example graphs (resources/example-workflows) — served
# read-only through GET /workflows so the editor can open them directly; the
# directory is named by SR_EXAMPLE_WORKFLOWS (default: resources/example-workflows
# in the checkout, absent unless copied there)
EXAMPLE_WORKFLOWS_DIR = os.environ.get(
    "SR_EXAMPLE_WORKFLOWS", str(REPO_ROOT / "resources" / "example-workflows")
)


@dataclass(order=True)
class QueueTask:
    priority: float
    prompt_id: int  # compared: restores FIFO for equal priorities (the
    # reference PromptQueue keeps submission order via a monotone counter)
    workflow: dict = field(compare=False)
    extra: dict = field(compare=False, default_factory=dict)


class PromptQueue:
    """Priority prompt queue + bounded history (execution.py:1515-1617)."""

    def __init__(self):
        self.mutex = threading.RLock()
        self.not_empty = threading.Condition(self.mutex)
        self.task_counter = 0
        self.queue: List[QueueTask] = []
        self.currently_running: Dict[int, QueueTask] = {}
        self.history: Dict[int, dict] = {}

    def put(self, workflow: dict, priority: float = 0.0,
            extra: Optional[dict] = None) -> int:
        with self.mutex:
            pid = self.task_counter
            self.task_counter += 1
            heapq.heappush(self.queue, QueueTask(priority, pid, workflow, extra or {}))
            self.not_empty.notify()
            return pid

    def get(self, timeout: Optional[float] = None) -> Optional[QueueTask]:
        with self.not_empty:
            while not self.queue:
                self.not_empty.wait(timeout=timeout)
                if timeout is not None and not self.queue:
                    return None
            item = heapq.heappop(self.queue)
            self.currently_running[item.prompt_id] = item
            return item

    def task_done(self, prompt_id: int, status: str = "success",
                  messages: Optional[List[str]] = None) -> None:
        with self.mutex:
            item = self.currently_running.pop(prompt_id, None)
            if len(self.history) >= MAX_HISTORY:
                self.history.pop(next(iter(self.history)))
            self.history[prompt_id] = {
                "prompt_id": prompt_id,
                "status": status,
                "completed": status == "success",
                "messages": messages or [],
                "workflow": None if item is None else item.workflow,
                "ts": time.time(),
            }

    def get_history(self) -> List[dict]:
        with self.mutex:
            return list(self.history.values())

    def get_history_item(self, prompt_id: int) -> Optional[dict]:
        with self.mutex:
            return self.history.get(prompt_id)

    def queue_info(self) -> dict:
        with self.mutex:
            return {
                "queue_pending": len(self.queue),
                "queue_running": len(self.currently_running),
                "task_counter": self.task_counter,
            }

    # --- queue/history management (reference server.py POST /queue and
    # POST /history: {"clear": bool} wipes, {"delete": [ids]} removes items;
    # GET /queue returns the running + pending entries) ---

    def get_current_queue(self) -> dict:
        with self.mutex:
            running = [[t.priority, t.prompt_id, t.workflow]
                       for t in self.currently_running.values()]
            pending = [[t.priority, t.prompt_id, t.workflow]
                       for t in sorted(self.queue)]
            return {"queue_running": running, "queue_pending": pending}

    def delete_queue_items(self, prompt_ids) -> int:
        with self.mutex:
            ids = {int(i) for i in prompt_ids}
            keep = [t for t in self.queue if t.prompt_id not in ids]
            removed = len(self.queue) - len(keep)
            self.queue = keep
            heapq.heapify(self.queue)
            return removed

    def wipe_queue(self) -> int:
        with self.mutex:
            n = len(self.queue)
            self.queue = []
            return n

    def delete_history_items(self, prompt_ids) -> int:
        with self.mutex:
            n = 0
            for pid in prompt_ids:
                if self.history.pop(int(pid), None) is not None:
                    n += 1
            return n

    def wipe_history(self) -> int:
        with self.mutex:
            n = len(self.history)
            self.history = {}
            return n


_INDEX_HTML = b"""<!doctype html>
<html><head><title>stable_renderer_tpu_torch</title>
<style>body{background:#111;color:#ddd;font-family:monospace;text-align:center}
img{image-rendering:pixelated;max-width:90vw;border:1px solid #444}
textarea{width:60%;height:6em;background:#222;color:#ddd;border:1px solid #444}
button{background:#333;color:#ddd;border:1px solid #555;padding:4px 14px}</style>
</head><body>
<h3>stable_renderer_tpu_torch live view</h3>
<p><a href="/editor" style="color:#7aa2f7">graph editor</a> &middot;
<a href="/hierarchy" style="color:#7aa2f7">scene hierarchy</a></p>
<img src="/stream" alt="render stream"/>
<p id="s"></p>
<details><summary>submit workflow JSON</summary>
<textarea id="wf" placeholder='{"nodes": [...], "links": [...]}'></textarea><br/>
<button onclick="submitWf()">POST /prompt</button> <span id="r"></span>
</details>
<div><progress id="p" value="0" max="1" style="width:60%"></progress>
<span id="pt"></span></div>
<img id="preview" style="max-width:256px;display:none"/>
<script>
setInterval(async()=>{const r=await fetch('/status');
document.getElementById('s').textContent=JSON.stringify(await r.json());},1000);
const es=new EventSource('/events');
es.onmessage=(m)=>{const e=JSON.parse(m.data);
  if(e.type==='progress'){const d=e.data;
    document.getElementById('p').value=d.step; document.getElementById('p').max=d.total;
    document.getElementById('pt').textContent=d.step+'/'+d.total;
    if(d.preview){const im=document.getElementById('preview');
      im.src='data:image/jpeg;base64,'+d.preview; im.style.display='inline';}}
  if(e.type==='executed'){document.getElementById('pt').textContent=
    'done: '+JSON.stringify(e.data);}};
async function submitWf(){
  try{
    const wf=JSON.parse(document.getElementById('wf').value);
    const r=await fetch('/prompt',{method:'POST',body:JSON.stringify({prompt:wf})});
    document.getElementById('r').textContent=JSON.stringify(await r.json());
  }catch(e){document.getElementById('r').textContent=String(e);}
}
</script></body></html>"""


def _encode_png(frame: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame[..., :3]).save(buf, format="PNG")
    return buf.getvalue()


def _encode_jpeg(frame: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame[..., :3]).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


# --- RFC6455 websocket (server side, stdlib only) -------------------------
# The reference pushes status/progress/executing events over an aiohttp
# websocket at /ws (comfyUI/server.py:114-180); this is the same wire
# protocol hand-rolled on the stdlib HTTP server (handshake + unmasked
# server->client text frames + ping/pong/close handling).

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept_key(key: str) -> str:
    import hashlib

    return base64.b64encode(
        hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()


def _ws_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    """One FIN frame, server->client (never masked)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + n.to_bytes(2, "big")
    else:
        head += bytes([127]) + n.to_bytes(8, "big")
    return head + payload


def _ws_read_frame(rfile) -> Optional[Tuple[int, bytes]]:
    """Read one (possibly masked) client frame; None on EOF."""
    hdr = rfile.read(2)
    if not hdr or len(hdr) < 2:
        return None
    opcode = hdr[0] & 0x0F
    masked = hdr[1] & 0x80
    ln = hdr[1] & 0x7F
    if ln == 126:
        ln = int.from_bytes(rfile.read(2), "big")
    elif ln == 127:
        ln = int.from_bytes(rfile.read(8), "big")
    mask = rfile.read(4) if masked else b""
    payload = rfile.read(ln) if ln else b""
    if masked and payload:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class FrameServer:
    """Latest-frame mailbox + HTTP endpoints. Start with ``start()``; publish
    uint8 frames from the engine loop via ``publish``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8188):
        self.host = host
        self.port = port
        self.queue = PromptQueue()
        self._frame: Optional[np.ndarray] = None
        self._frame_index = -1
        self._frame_cv = threading.Condition()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, Any] = {}
        # SSE event bus (the reference pushes progress/status over a
        # websocket, comfyUI/server.py:114-180; SSE is the dependency-free
        # HTTP equivalent — every /events client gets its own queue)
        self._subscribers: list = []
        self._sub_lock = threading.Lock()
        # model search dirs (set by serve_workflows / CLI) — used by
        # /embeddings and /view_metadata
        self.model_dirs: Tuple[str, ...] = ()
        # browser-saved workflow JSONs (GET/POST /workflows)
        self.workflow_save_dir: str = os.path.join("outputs", "workflows")
        # cross-prompt executor cache (reference PromptExecutor keeps its
        # output cache across prompts, execution.py:1013-1035 — identical
        # workflow JSON resubmits reuse the loaded models, on the card)
        self.executor_cache: Dict[str, Any] = {}

    # --- event bus (push) ---

    def post_event(self, event_type: str, data: Dict[str, Any]) -> None:
        """Push an event to every connected /events client (non-blocking;
        slow clients drop events beyond a 256-entry backlog)."""
        import queue as _q

        evt = {"type": event_type, "data": data}
        with self._sub_lock:
            subs = list(self._subscribers)
        for q in subs:
            try:
                q.put_nowait(evt)
            except _q.Full:
                pass

    def _subscribe(self):
        import queue as _q

        q = _q.Queue(maxsize=256)
        with self._sub_lock:
            self._subscribers.append(q)
        return q

    def _unsubscribe(self, q) -> None:
        with self._sub_lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    # --- engine side ---

    def publish(self, frame: np.ndarray, frame_index: int = -1) -> None:
        if frame.dtype != np.uint8:
            frame = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
        with self._frame_cv:
            self._frame = np.asarray(frame)
            self._frame_index = frame_index
            self._frame_cv.notify_all()

    def frame_callback(self, frame: np.ndarray, frame_index: int) -> None:
        """Drop-in for Engine(frame_callback=...)."""
        self.publish(frame, frame_index)

    # --- scene hierarchy / inspector (reference ui/main.py left panel:
    # gameobject list + inspector; served here as /scene + /hierarchy) ---

    def attach_engine(self, engine) -> None:
        """Expose a running engine's scene graph to /scene (+ editor panel)."""
        import weakref

        self._engine_ref = weakref.ref(engine)

    def _engine(self):
        ref = getattr(self, "_engine_ref", None)
        return ref() if ref is not None else None

    def scene_tree(self) -> Optional[list]:
        """JSON-able GameObject tree: name/active/tags/components/transform."""
        engine = self._engine()
        if engine is None:
            return None
        from stable_renderer_tpu_torch.engine.gameobj import GameObject

        def node(obj):
            tr = obj.transform
            return {
                "name": obj.name,
                "active": bool(obj.active),
                "tags": sorted(obj.tags),
                "components": [type(c).__name__ for c in obj.components],
                "transform": {
                    "position": [float(v) for v in tr.localPosition],
                    "eulerAngles": [float(v) for v in tr.localEulerAngles],
                    "scale": [float(v) for v in tr.localScale],
                },
                "children": [node(c) for c in obj.children],
            }

        return [node(r) for r in GameObject.roots()]

    def scene_update(self, payload: dict) -> dict:
        """Inspector edit: set active/position/eulerAngles/scale on a
        GameObject by name (the reference editor mutates the live scene the
        same way through Qt widgets)."""
        engine = self._engine()
        if engine is None:
            return {"error": "no engine attached"}
        from stable_renderer_tpu_torch.engine.gameobj import GameObject

        obj = GameObject.find_by_name(str(payload.get("name", "")))
        if obj is None:
            return {"error": f"no object named {payload.get('name')!r}"}
        if "active" in payload:
            obj.active = bool(payload["active"])
        tr = obj.transform
        if payload.get("position") is not None:
            tr.localPosition = [float(v) for v in payload["position"]]
        if payload.get("eulerAngles") is not None:
            tr.localEulerAngles = [float(v) for v in payload["eulerAngles"]]
        if payload.get("scale") is not None:
            tr.localScale = [float(v) for v in payload["scale"]]
        return {"ok": True, "name": obj.name}

    def _ws_loop(self, conn, rfile, wfile) -> None:
        """Post-handshake websocket session: relay the event bus as JSON text
        frames, answer pings, honor close (reference /ws event stream,
        comfyUI/server.py:114-180)."""
        import queue as _q
        import select

        q = self._subscribe()
        try:
            with self._frame_cv:
                idx = self._frame_index
            hello = {"type": "status",
                     "data": {"status": {"exec_info": self.queue.queue_info()},
                              "frame": idx}}
            wfile.write(_ws_frame(json.dumps(hello).encode()))
            wfile.flush()
            idle = 0.0
            while True:
                # drain any client frames without blocking the push loop
                r, _, _ = select.select([conn], [], [], 0.0)
                if r:
                    got = _ws_read_frame(rfile)
                    if got is None:
                        return
                    opcode, payload = got
                    if opcode == 0x8:  # close: echo and drop
                        wfile.write(_ws_frame(payload[:2], 0x8))
                        wfile.flush()
                        return
                    if opcode == 0x9:  # ping -> pong
                        wfile.write(_ws_frame(payload, 0xA))
                        wfile.flush()
                    continue
                try:
                    # short waits, so client frames (ping, close) are
                    # answered within WS_POLL_S; a keepalive ping every 5 s
                    evt = q.get(timeout=WS_POLL_S)
                except _q.Empty:
                    idle += WS_POLL_S
                    if idle >= 5.0:
                        idle = 0.0
                        wfile.write(_ws_frame(b"", 0x9))  # keepalive ping
                        wfile.flush()
                    continue
                idle = 0.0
                wfile.write(_ws_frame(json.dumps(evt).encode()))
                wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            return
        finally:
            self._unsubscribe(q)

    def embeddings(self) -> List[str]:
        """Textual-inversion embedding names visible to CLIPTextEncode
        (reference /embeddings, comfyUI/server.py:196-199: stem list of the
        embeddings folders). Scans every model dir plus its ``embeddings/``
        subdir for .pt/.bin/.safetensors files."""
        names: List[str] = []
        exts = {".pt", ".bin", ".safetensors"}
        for d in self.model_dirs:
            for root in (Path(d), Path(d) / "embeddings"):
                if not root.is_dir():
                    continue
                for f in sorted(root.iterdir()):
                    if f.is_file() and f.suffix.lower() in exts:
                        names.append(f.stem)
        return sorted(dict.fromkeys(names))

    def view_metadata(self, folder: str, filename: str) -> Optional[dict]:
        """safetensors __metadata__ of a model file (reference
        /view_metadata/{folder_name}, comfyUI/server.py:432-453). The file is
        resolved by name under the model dirs (optionally inside a ``folder``
        subdir); only the 8-byte-length-prefixed JSON header is read."""
        filename = os.path.basename(filename)
        if not filename.endswith(".safetensors"):
            return None
        candidates: List[Path] = []
        for d in self.model_dirs:
            candidates += [Path(d) / folder / filename, Path(d) / filename]
        for path in candidates:
            if not path.is_file():
                continue
            try:
                with open(path, "rb") as f:
                    hlen = int.from_bytes(f.read(8), "little")
                    if hlen <= 0 or hlen > 256 * 1024 * 1024:
                        return None
                    header = json.loads(f.read(hlen))
                return header.get("__metadata__", {})
            except (OSError, ValueError):
                return None
        return None

    def free(self, unload_models: bool = False,
             free_memory: bool = False) -> dict:
        """POST /free semantics (reference server.py:637-646 + PromptQueue
        set_flag): drop cached executors (the loaded models they hold on the
        card become collectable) and/or collect them and release the card's
        cached blocks (``torch.cuda.empty_cache``). Reports the executors
        dropped and the bytes ``torch.cuda.memory_reserved()`` went down by
        (0 without a card in use)."""
        import torch

        out = {"unloaded_executors": 0, "freed_bytes": 0}
        if unload_models:
            out["unloaded_executors"] = len(self.executor_cache)
            self.executor_cache.clear()
        if free_memory:
            import gc

            self.executor_cache.clear()
            gc.collect()
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                before = torch.cuda.memory_reserved()
                torch.cuda.empty_cache()
                out["freed_bytes"] = before - torch.cuda.memory_reserved()
        return out

    @staticmethod
    def system_stats() -> Dict[str, Any]:
        """Host + device inventory (reference /system_stats,
        comfyUI/server.py:455-479: os/python + per-device vram totals)."""
        import platform as _platform
        import sys as _sys

        out: Dict[str, Any] = {
            "system": {
                "os": _platform.system(),
                "python_version": _sys.version,
                "embedded_python": False,
            },
            "devices": [],
        }
        import torch

        if torch.cuda.is_available():
            # a card that is present but cannot be queried raises
            for i in range(torch.cuda.device_count()):
                free, total = torch.cuda.mem_get_info(i)
                out["devices"].append({
                    "name": torch.cuda.get_device_name(i),
                    "type": "cuda",
                    "index": i,
                    "vram_total": int(total),
                    "vram_free": int(free),
                })
        else:
            out["devices"].append({"name": "cpu", "type": "cpu", "index": 0,
                                   "vram_total": 0, "vram_free": 0})
        return out

    @staticmethod
    def object_info() -> Dict[str, Any]:
        """Node introspection from the validation NODE_SPECS + executor
        registry — comfy /object_info shape: input types, widget contracts
        (type/min/max/choices) and return types per node."""
        from stable_renderer_tpu_torch.workflow.executor import NODE_REGISTRY
        from stable_renderer_tpu_torch.workflow.validation import NODE_SPECS

        info: Dict[str, Any] = {}
        for name in sorted(NODE_REGISTRY):
            spec = NODE_SPECS.get(name)
            entry: Dict[str, Any] = {
                "name": name,
                "input": {"required": {}},
                "output": list(spec.return_types) if spec else ["ANY"],
            }
            if spec:
                for k, t in spec.input_types.items():
                    entry["input"]["required"][k] = [t]
                for w in spec.widgets:
                    opts: Dict[str, Any] = {}
                    if w.min is not None:
                        opts["min"] = w.min
                    if w.max is not None:
                        opts["max"] = w.max
                    if w.choices:
                        entry["input"]["required"][w.name] = [list(w.choices)]
                        continue
                    entry["input"]["required"][w.name] = [w.type, opts]
                if spec.lazy_inputs:
                    entry["lazy_inputs"] = list(spec.lazy_inputs)
            info[name] = entry
        return info

    # --- server lifecycle ---

    def start(self) -> "FrameServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route into our logger
                logger.debug("http: " + fmt % args)

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_INDEX_HTML)
                elif self.path.startswith("/editor"):
                    # the in-browser graph editor (reference: ComfyUI web
                    # frontend embedded in the PySide6 editor)
                    from stable_renderer_tpu_torch.editor_page import EDITOR_HTML

                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(EDITOR_HTML)
                elif self.path.startswith("/frame"):
                    with server._frame_cv:
                        frame = server._frame
                    if frame is None:
                        self._json({"error": "no frame yet"}, 404)
                        return
                    png = _encode_png(frame)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
                elif self.path.startswith("/stream"):
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=srtpuframe")
                    self.end_headers()
                    last = -2
                    try:
                        while True:
                            with server._frame_cv:
                                if server._frame_index == last:
                                    server._frame_cv.wait(timeout=1.0)
                                frame = server._frame
                                last = server._frame_index
                            if frame is None:
                                continue
                            jpg = _encode_jpeg(frame)
                            self.wfile.write(b"--srtpuframe\r\n")
                            self.wfile.write(b"Content-Type: image/jpeg\r\n")
                            self.wfile.write(
                                f"Content-Length: {len(jpg)}\r\n\r\n".encode())
                            self.wfile.write(jpg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                elif self.path.startswith("/ws"):
                    # RFC6455 websocket event push (reference /ws,
                    # comfyUI/server.py:114-180)
                    key = self.headers.get("Sec-WebSocket-Key")
                    upgrade = (self.headers.get("Upgrade") or "").lower()
                    if not key or "websocket" not in upgrade:
                        self._json({"error": "websocket upgrade required"}, 400)
                        return
                    self.wfile.write(
                        b"HTTP/1.1 101 Switching Protocols\r\n"
                        b"Upgrade: websocket\r\n"
                        b"Connection: Upgrade\r\n"
                        b"Sec-WebSocket-Accept: "
                        + _ws_accept_key(key).encode() + b"\r\n\r\n")
                    self.wfile.flush()
                    self.close_connection = True
                    server._ws_loop(self.connection, self.rfile, self.wfile)
                elif self.path.startswith("/events"):
                    # server-sent events: progress / status / frame pushes
                    q = server._subscribe()
                    try:
                        self.send_response(200)
                        self.send_header("Content-Type", "text/event-stream")
                        self.send_header("Cache-Control", "no-cache")
                        self.end_headers()
                        import queue as _q

                        while True:
                            try:
                                evt = q.get(timeout=15.0)
                                payload = json.dumps(evt)
                            except _q.Empty:
                                payload = '{"type": "ping"}'
                            self.wfile.write(
                                f"data: {payload}\n\n".encode())
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        return
                    finally:
                        server._unsubscribe(q)
                elif self.path.startswith("/object_info"):
                    # node introspection generated from NODE_SPECS
                    # (reference /object_info, comfyUI/server.py:560-600)
                    from urllib.parse import unquote

                    info = server.object_info()
                    rest = self.path[len("/object_info"):].strip("/")
                    if rest:
                        name = unquote(rest.split("?")[0])
                        if name not in info:
                            self._json({"error": f"unknown node {name}"}, 404)
                            return
                        info = {name: info[name]}
                    self._json(info)
                elif self.path.startswith("/workflows"):
                    # browser save/load of workflow JSONs (reference: the
                    # litegraph frontend's save/load + resources/
                    # example-workflows). GET /workflows lists example +
                    # saved graphs; GET /workflows/<name> returns one.
                    from urllib.parse import unquote

                    rest = unquote(self.path[len("/workflows"):].strip("/"))
                    ex_dir = Path(EXAMPLE_WORKFLOWS_DIR)
                    saved_dir = Path(server.workflow_save_dir)
                    if not rest:
                        self._json({
                            "examples": sorted(
                                p.name for p in ex_dir.glob("*.json")
                            ) if ex_dir.is_dir() else [],
                            "saved": sorted(
                                p.name for p in saved_dir.glob("*.json")
                            ) if saved_dir.is_dir() else [],
                        })
                        return
                    name = Path(rest.split("?")[0]).name  # no traversal
                    for d in (saved_dir, ex_dir):
                        cand = d / name
                        if cand.is_file():
                            try:
                                self._json(json.loads(cand.read_text()))
                            except ValueError:
                                self._json({"error": f"bad JSON in {name}"}, 500)
                            return
                    self._json({"error": f"no workflow named {name}"}, 404)
                elif self.path.startswith("/view_metadata"):
                    # safetensors header metadata of a model file
                    # (reference /view_metadata/{folder}, server.py:432-453)
                    from urllib.parse import parse_qs, unquote, urlparse

                    parsed = urlparse(self.path)
                    folder = unquote(
                        parsed.path[len("/view_metadata"):].strip("/"))
                    filename = (parse_qs(parsed.query).get("filename")
                                or [""])[0]
                    if not filename:
                        self._json({"error": "filename required"}, 400)
                        return
                    meta = server.view_metadata(folder, filename)
                    if meta is None:
                        self._json({"error": "not found"}, 404)
                    else:
                        self._json(meta)
                elif self.path.startswith("/view"):
                    # serve an output file (reference /view, server.py:391-455)
                    from urllib.parse import parse_qs, urlparse

                    from stable_renderer_tpu_torch.utils.paths import OUTPUT_DIR

                    qs = parse_qs(urlparse(self.path).query)
                    filename = (qs.get("filename") or [""])[0]
                    subfolder = (qs.get("subfolder") or [""])[0]
                    base = (Path(OUTPUT_DIR) / subfolder).resolve()
                    target = (base / filename).resolve()
                    out_root = Path(OUTPUT_DIR).resolve()
                    if (not filename or out_root not in target.parents
                            and target != out_root):
                        self._json({"error": "invalid path"}, 403)
                        return
                    if not target.is_file():
                        self._json({"error": "not found"}, 404)
                        return
                    ctype = {
                        ".png": "image/png", ".jpg": "image/jpeg",
                        ".jpeg": "image/jpeg", ".gif": "image/gif",
                        ".webp": "image/webp", ".npy": "application/octet-stream",
                        ".json": "application/json",
                    }.get(target.suffix.lower(), "application/octet-stream")
                    data = target.read_bytes()
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/unique_node_types"):
                    # reference custom route (comfyUI/server.py:283-285)
                    from stable_renderer_tpu_torch.workflow.validation import (
                        UNIQUE_NODE_TYPES,
                    )

                    self._json(sorted(UNIQUE_NODE_TYPES))
                elif self.path.startswith("/type_matchings"):
                    # reference custom route (comfyUI/server.py:524-528)
                    from stable_renderer_tpu_torch.workflow.validation import (
                        type_matchings,
                    )

                    self._json(type_matchings())
                elif self.path.startswith("/scene"):
                    tree = server.scene_tree()
                    if tree is None:
                        self._json({"error": "no engine attached"}, 404)
                    else:
                        self._json({"scene": tree})
                elif self.path.startswith("/hierarchy"):
                    from stable_renderer_tpu_torch.editor_page import HIERARCHY_HTML

                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(HIERARCHY_HTML)
                elif self.path.startswith("/history"):
                    # /history/{prompt_id} returns one item (reference
                    # server.py:556-559); bare /history returns all
                    rest = self.path[len("/history"):].strip("/").split("?")[0]
                    if rest:
                        try:
                            item = server.queue.get_history_item(int(rest))
                        except ValueError:
                            item = None
                        if item is None:
                            self._json({"error": "not found"}, 404)
                        else:
                            self._json(item)
                    else:
                        self._json(server.queue.get_history())
                elif self.path.startswith("/queue"):
                    # running + pending entries (reference server.py:561-567)
                    self._json(server.queue.get_current_queue())
                elif self.path.startswith("/prompt"):
                    # GET /prompt: queue size for frontends
                    # (reference server.py:481-484)
                    info = server.queue.queue_info()
                    self._json({"exec_info": {"queue_remaining":
                                info["queue_pending"] + info["queue_running"]}})
                elif self.path.startswith("/embeddings"):
                    self._json(server.embeddings())
                elif self.path.startswith("/extensions"):
                    # frontend JS extensions — none ship (the graph editor is
                    # self-contained); reference server.py:201-209
                    self._json([])
                elif self.path.startswith("/system_stats"):
                    self._json(server.system_stats())
                elif self.path.startswith("/status"):
                    with server._frame_cv:
                        idx = server._frame_index
                    self._json({"frame": idx, **server.queue.queue_info(),
                                **server.stats})
                else:
                    self._json({"error": f"unknown path {self.path}"}, 404)

            def do_POST(self):
                if self.path.startswith("/prompt"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as ex:
                        self._json({"error": f"bad json: {ex}"}, 400)
                        return
                    wf = payload.get("prompt", payload)
                    pid = server.queue.put(wf,
                                           priority=payload.get("priority", 0.0))
                    server.post_event("queued", {"prompt_id": pid})
                    self._json({"prompt_id": pid})
                elif self.path.startswith("/workflows/save"):
                    # persist a browser-built graph (reference frontend save)
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as ex:
                        self._json({"error": f"bad json: {ex}"}, 400)
                        return
                    name = Path(str(payload.get("name") or "workflow")).name
                    if not name.endswith(".json"):
                        name += ".json"
                    wf = payload.get("workflow")
                    if not isinstance(wf, dict) or "nodes" not in wf:
                        self._json({"error": "workflow must be a graph dict"}, 400)
                        return
                    d = Path(server.workflow_save_dir)
                    d.mkdir(parents=True, exist_ok=True)
                    (d / name).write_text(json.dumps(wf, indent=1))
                    self._json({"saved": name})
                elif self.path.startswith("/scene/update") or self.path.startswith("/scene"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as ex:
                        self._json({"error": f"bad json: {ex}"}, 400)
                        return
                    out = server.scene_update(payload)
                    self._json(out, 200 if "error" not in out else 404)
                elif self.path.startswith("/interrupt"):
                    # abort the running prompt at the next node boundary
                    # (reference server.py:632-635 -> interrupt_current_processing)
                    from stable_renderer_tpu_torch.workflow.executor import (
                        interrupt_processing,
                    )

                    interrupt_processing(True)
                    server.post_event("interrupted", {})
                    self._json({"ok": True})
                elif self.path.startswith("/free"):
                    # unload models / free device memory
                    # (reference server.py:637-646)
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as ex:
                        self._json({"error": f"bad json: {ex}"}, 400)
                        return
                    self._json(server.free(
                        unload_models=bool(payload.get("unload_models")),
                        free_memory=bool(payload.get("free_memory"))))
                elif self.path.startswith("/queue"):
                    # {"clear": true} wipes pending; {"delete": [ids]} removes
                    # (reference server.py:618-630)
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as ex:
                        self._json({"error": f"bad json: {ex}"}, 400)
                        return
                    out = {}
                    if payload.get("clear"):
                        out["cleared"] = server.queue.wipe_queue()
                    if payload.get("delete"):
                        out["deleted"] = server.queue.delete_queue_items(
                            payload["delete"])
                    self._json(out)
                elif self.path.startswith("/history"):
                    # {"clear": true} / {"delete": [ids]}
                    # (reference server.py:648-659)
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as ex:
                        self._json({"error": f"bad json: {ex}"}, 400)
                        return
                    out = {}
                    if payload.get("clear"):
                        out["cleared"] = server.queue.wipe_history()
                    if payload.get("delete"):
                        out["deleted"] = server.queue.delete_history_items(
                            payload["delete"])
                    self._json(out)
                elif (self.path.startswith("/upload/image")
                      or self.path.startswith("/upload/mask")
                      or self.path.startswith("/upload")):
                    # accept a raw image body (or simple multipart) into
                    # OUTPUT_DIR/input (reference /upload/image + /upload/mask,
                    # server.py:287-343; masks land in input/masks)
                    from stable_renderer_tpu_torch.utils.paths import OUTPUT_DIR

                    n = int(self.headers.get("Content-Length", 0))
                    if n <= 0 or n > 256 * 1024 * 1024:
                        self._json({"error": "bad content length"}, 400)
                        return
                    body = self.rfile.read(n)
                    ctype = self.headers.get("Content-Type", "")
                    filename = "upload.png"
                    if "multipart/form-data" in ctype and "boundary=" in ctype:
                        boundary = ctype.split("boundary=")[-1].encode()
                        for part in body.split(b"--" + boundary):
                            if b"filename=" in part:
                                head, _, content = part.partition(b"\r\n\r\n")
                                fn = head.split(b'filename="')[-1].split(b'"')[0]
                                filename = fn.decode() or filename
                                body = content.rsplit(b"\r\n", 1)[0]
                                break
                    else:
                        from urllib.parse import parse_qs, urlparse

                        qs = parse_qs(urlparse(self.path).query)
                        filename = (qs.get("filename") or [filename])[0]
                    filename = os.path.basename(filename)
                    sub = ("input/masks" if self.path.startswith("/upload/mask")
                           else "input")
                    d = Path(OUTPUT_DIR) / sub
                    d.mkdir(parents=True, exist_ok=True)
                    (d / filename).write_bytes(body)
                    self._json({"name": filename, "subfolder": sub,
                                "type": "input"})
                else:
                    self._json({"error": f"unknown path {self.path}"}, 404)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]  # resolve port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever, args=(0.05,),
                                        daemon=True, name="sr-tpu-torch-http")
        self._thread.start()
        logger.info(f"viewer at http://{self.host}:{self.port}/")
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def _to_host(x) -> np.ndarray:
    """A tensor (on any device) or array as a float32 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def serve_workflows(server: FrameServer, model_dirs: Tuple[str, ...] = (),
                    engine_data_fn=None, poll_timeout: float = 1.0,
                    max_prompts: Optional[int] = None, device=None) -> None:
    """Worker loop: drain the prompt queue with PromptExecutor (the reference
    main.run() prompt_worker, main.py). Blocks; run it on the thread that
    owns the executors.

    Executors are cached by the workflow JSON: resubmitting the same graph
    reuses its loaded models (the reference's cross-prompt (node_id,
    node_type) output cache, execution.py:1013-1035). POST /free with
    unload_models drops the cache. ``device`` goes to every PromptExecutor
    (default: the card; it raises without one unless ``"cpu"`` is asked
    for)."""
    from stable_renderer_tpu_torch.device import resolve_device

    device = resolve_device(device)  # no card and no device: raise here, not a prompt
    server.model_dirs = tuple(model_dirs) or server.model_dirs
    done = 0
    while max_prompts is None or done < max_prompts:
        task = server.queue.get(timeout=poll_timeout)
        if task is None:
            continue
        # one call a prompt: its executor, context and frames are the call's
        # locals, so nothing outlives the prompt but the executor cache
        _run_prompt(server, task, model_dirs, engine_data_fn, device)
        done += 1


def _run_prompt(server: FrameServer, task: QueueTask, model_dirs, engine_data_fn,
                device) -> None:
    from stable_renderer_tpu_torch.workflow.executor import (
        InterruptProcessingException,
        NodeExecutionError,
        PromptExecutor,
        interrupt_processing,
    )
    from stable_renderer_tpu_torch.workflow.loader import Workflow

    try:
        wf_key = json.dumps(task.workflow, sort_keys=True, default=str)
        ex = server.executor_cache.get(wf_key)
        if ex is None:
            wf = Workflow.from_dict(task.workflow)
            ex = PromptExecutor(wf, model_dirs=model_dirs, device=device)
            server.executor_cache[wf_key] = ex
        interrupt_processing(False)  # a stale flag must not kill this run

        def _progress(step: int, total: int, preview, _pid=task.prompt_id) -> None:
            # per-denoise-step SSE event with a small latent preview
            # (reference websocket progress + previews, main.py:187-195)
            data: Dict[str, Any] = {"prompt_id": _pid, "step": step + 1,
                                    "total": total}
            if preview is not None:
                img = np.clip(_to_host(preview) * 255.0, 0, 255).astype(np.uint8)
                if img.ndim == 4:
                    img = img[0]
                data["preview"] = base64.b64encode(
                    _encode_jpeg(img, quality=70)).decode()
            server.post_event("progress", data)

        ex.progress_holder[0] = _progress
        server.post_event("execution_start", {"prompt_id": task.prompt_id})
        ed = engine_data_fn() if engine_data_fn is not None else None
        ctx = ex.execute(engine_data=ed)
        out = ctx.final_output
        if isinstance(out, dict):
            out = out.get("samples")
        if out is not None and getattr(out, "ndim", 0) >= 3:
            arr = _to_host(out)
            if arr.ndim == 4:
                arr = arr[0]
            if arr.shape[-1] not in (1, 3, 4):  # latent: preview via slice
                arr = arr[..., :3]
            server.publish(arr[..., :3], task.prompt_id)
        server.queue.task_done(task.prompt_id, "success", ctx.status_messages)
        server.post_event("executed", {"prompt_id": task.prompt_id,
                                       "status": "success"})
    except InterruptProcessingException:
        logger.info(f"prompt {task.prompt_id} interrupted")
        server.queue.task_done(task.prompt_id, "interrupted", [])
        server.post_event("executed", {"prompt_id": task.prompt_id,
                                       "status": "interrupted"})
    except NodeExecutionError as ex:
        # structured per-node failure (reference execution.py:969-982
        # "execution_error" message: node id/type, exception, inputs,
        # traceback, executed set) — rides history + SSE/websocket so the
        # editor highlights the failing node
        logger.error(
            f"prompt {task.prompt_id} failed at node "
            f"{ex.details.get('node_id')} ({ex.details.get('node_type')}): "
            f"{ex.details.get('exception_message')}")
        server.queue.task_done(task.prompt_id, "error", [ex.details])
        server.post_event("execution_error",
                          dict(ex.details, prompt_id=task.prompt_id))
        server.post_event("executed", {"prompt_id": task.prompt_id,
                                       "status": "error",
                                       "error": ex.details})
    except Exception as ex:  # noqa: BLE001 — the server survives bad prompts
        logger.error(f"prompt {task.prompt_id} failed: {ex}")
        server.queue.task_done(task.prompt_id, "error", [str(ex)])
        server.post_event("executed", {"prompt_id": task.prompt_id,
                                       "status": "error",
                                       "error": str(ex)})
