"""The port's HTTP viewer + prompt server (server.py, editor_page.py) and
EDITOR mode, on the CPU.

The first 25 tests are tests/test_server.py's, each against the port's
FrameServer on port 0 with ``device="cpu"`` for the executors. Then the
parity checks with the JAX package's server: /object_info,
/unique_node_types and /type_matchings return the same JSON, and one tiny
workflow POSTed to both servers gives the same history status and final
frame within test_torch_executor.py's bar (the JAX loader outputs and draws
handed to the port). Then the port's own: /system_stats and /free on the
CPU and with a card present, ``serve --max-prompts 1 --device cpu``, serve
without a card, and Engine.RunEditor. Every HTTP call has a timeout of 5 s
or less; stream reads run in daemon threads joined with a timeout.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from stable_renderer_tpu_torch.server import FrameServer, PromptQueue, serve_workflows

torch.set_num_threads(1)

CPU = "cpu"


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read(), r.headers


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status, json.loads(r.read())


@pytest.fixture
def server():
    s = FrameServer(port=0).start()  # ephemeral port
    yield s
    s.stop()


LATENT_WF = {
    "nodes": [
        {"id": 1, "type": "EmptyLatentImage", "widgets_values": [64, 64, 1]},
        {"id": 2, "type": "InferenceOutput", "inputs": [{"name": "value", "link": 10}]},
    ],
    "links": [[10, 1, 0, 2, 0, "LATENT"]],
}


# --- tests/test_server.py's tests, against the port ---------------------------------


def test_prompt_queue_priority_and_history():
    q = PromptQueue()
    a = q.put({"n": "low"}, priority=5.0)
    b = q.put({"n": "hi"}, priority=-1.0)
    t1 = q.get()
    assert t1.prompt_id == b  # lower priority value first (heapq)
    q.task_done(t1.prompt_id, "success")
    t2 = q.get()
    q.task_done(t2.prompt_id, "error", ["boom"])
    hist = q.get_history()
    assert {h["prompt_id"] for h in hist} == {a, b}
    assert [h for h in hist if h["prompt_id"] == t2.prompt_id][0]["status"] == "error"
    assert q.queue_info()["queue_pending"] == 0


def test_index_status_and_frame_endpoints(server):
    base = f"http://127.0.0.1:{server.port}"
    code, body, _ = _get(base + "/")
    assert code == 200 and b"stream" in body
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/frame.png")
    assert ei.value.code == 404
    server.publish(np.full((16, 16, 3), 0.5, np.float32), frame_index=7)
    code, body, headers = _get(base + "/frame.png")
    assert code == 200 and headers["Content-Type"] == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    code, body, _ = _get(base + "/status")
    assert json.loads(body)["frame"] == 7


def _read_stream(base, got, parts=2):
    """/stream until ``parts`` JPEG parts arrived (into got["data"])."""
    req = urllib.request.urlopen(base + "/stream", timeout=5)
    data = b""
    while data.count(b"\xff\xd8") < parts:  # JPEG SOI markers
        data += req.read(256)
    got["data"] = data
    req.close()


def test_mjpeg_stream_delivers_frames(server):
    base = f"http://127.0.0.1:{server.port}"
    server.publish(np.zeros((8, 8, 3), np.uint8), frame_index=0)
    got = {}
    t = threading.Thread(target=_read_stream, args=(base, got), daemon=True)
    t.start()
    for i in range(1, 20):
        time.sleep(0.05)
        server.publish(np.full((8, 8, 3), i * 10, np.uint8), frame_index=i)
        if "data" in got:
            break
    t.join(timeout=5)
    assert "data" in got
    assert b"image/jpeg" in got["data"]


def test_post_prompt_and_worker_executes(server):
    base = f"http://127.0.0.1:{server.port}"
    _, out = _post(base + "/prompt", {"prompt": LATENT_WF})
    pid = out["prompt_id"]
    serve_workflows(server, max_prompts=1, poll_timeout=0.1, device=CPU)
    hist = json.loads(_get(base + "/history")[1])
    assert hist and hist[0]["prompt_id"] == pid
    assert hist[0]["status"] == "success"
    # bad prompt -> error history entry, server survives
    _, out = _post(base + "/prompt", {"prompt": {"nodes": [
        {"id": 1, "type": "NopeNode", "widgets_values": []}], "links": []}})
    pid2 = out["prompt_id"]
    serve_workflows(server, max_prompts=1, poll_timeout=0.1, device=CPU)
    hist = json.loads(_get(base + "/history")[1])
    assert [h for h in hist if h["prompt_id"] == pid2][0]["status"] == "error"


def _ball_app(engine_cls):
    from stable_renderer_tpu_torch.engine.camera import Camera
    from stable_renderer_tpu_torch.engine.gameobj import GameObject
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.renderers import MeshRenderer

    class App(engine_cls):
        def beforePrepare(self):
            go = GameObject("ball")
            go.addComponent(MeshRenderer, mesh=Mesh.Sphere(1.0, 12))
            cam = GameObject("cam")
            cam.addComponent(Camera)
            cam.transform.position = [0.0, 0.5, 3.0]
            cam.transform.lookAt([0.0, 0.0, 0.0])

    return App


def _png(body):
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def test_engine_frame_callback_streams_to_server(server):
    """Engine(frame_callback=server.frame_callback) publishes rendered
    frames; /frame.png serves them."""
    from stable_renderer_tpu_torch.engine.engine import Engine

    Engine._reset()
    _ball_app(Engine).Run(winSize=(48, 48), disableComfyUI=True, max_frames=2,
                          frame_callback=server.frame_callback, device=CPU)
    Engine._reset()
    code, body, _ = _get(f"http://127.0.0.1:{server.port}/frame.png")
    assert code == 200 and body[:4] == b"\x89PNG"
    arr = _png(body)
    assert arr.shape[:2] == (48, 48) and arr.max() > 100


def test_object_info_endpoint(server):
    base = f"http://127.0.0.1:{server.port}"
    code, body, _ = _get(base + "/object_info")
    info = json.loads(body)
    assert code == 200 and len(info) > 80
    ks = info["KSampler"]
    assert "MODEL" in ks["input"]["required"]["model"]
    assert ks["output"] == ["LATENT"]
    code, body, _ = _get(base + "/object_info/VAEDecode")
    assert set(json.loads(body)) == {"VAEDecode"}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/object_info/NopeNode")
    assert ei.value.code == 404


def test_view_and_upload_endpoints(server, tmp_path, monkeypatch):
    import stable_renderer_tpu_torch.utils.paths as paths

    monkeypatch.setattr(paths, "OUTPUT_DIR", tmp_path)
    base = f"http://127.0.0.1:{server.port}"
    png = b"\x89PNG\r\n\x1a\n" + b"x" * 32
    req = urllib.request.Request(base + "/upload/image?filename=test_up.png", data=png,
                                 headers={"Content-Type": "image/png"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        meta = json.loads(r.read())
    assert meta["name"] == "test_up.png"
    assert (tmp_path / "input" / "test_up.png").read_bytes() == png
    code, body, hdrs = _get(base + "/view?filename=test_up.png&subfolder=input")
    assert code == 200 and body == png and hdrs["Content-Type"] == "image/png"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/view?filename=../../etc/passwd")
    assert ei.value.code in (403, 404)


def _drain(events):
    import queue as _q

    got = []
    try:
        while True:
            got.append(events.get_nowait())
    except _q.Empty:
        return got


SAMPLER_WF = {
    "nodes": [
        {"id": 1, "type": "CheckpointLoaderSimple", "widgets_values": ["x"]},
        {"id": 2, "type": "CLIPTextEncode", "widgets_values": ["hi"],
         "inputs": [{"name": "clip", "link": 1}]},
        {"id": 3, "type": "EmptyLatentImage", "widgets_values": [64, 64, 1]},
        {"id": 4, "type": "KSampler",
         "widgets_values": [0, "fixed", 2, 1.0, "euler", "normal", 1.0],
         "inputs": [{"name": "model", "link": 2}, {"name": "positive", "link": 3},
                    {"name": "latent_image", "link": 4}]},
        {"id": 5, "type": "InferenceOutput", "inputs": [{"name": "value", "link": 5}]},
    ],
    "links": [[1, 1, 1, 2, 0, "CLIP"], [2, 1, 0, 4, 0, "MODEL"],
              [3, 2, 0, 4, 1, "CONDITIONING"], [4, 3, 0, 4, 3, "LATENT"],
              [5, 4, 0, 5, 0, "LATENT"]],
}


def test_sse_progress_events_during_execution(server):
    """A KSampler workflow streams per-step progress (with latent previews)
    to the event bus while executing."""
    events = server._subscribe()
    _, out = _post(f"http://127.0.0.1:{server.port}/prompt", {"prompt": SAMPLER_WF})
    serve_workflows(server, max_prompts=1, poll_timeout=0.1, device=CPU)
    got = _drain(events)
    types = [e["type"] for e in got]
    assert "execution_start" in types and "executed" in types
    progress = [e for e in got if e["type"] == "progress"]
    assert len(progress) == 2
    assert progress[-1]["data"]["step"] == 2 and progress[-1]["data"]["total"] == 2
    assert "preview" in progress[-1]["data"]
    assert [e for e in got if e["type"] == "executed"][0]["data"]["prompt_id"] == \
        out["prompt_id"]


def test_graph_editor_page(server):
    code, body, hdrs = _get(f"http://127.0.0.1:{server.port}/editor")
    assert code == 200 and hdrs["Content-Type"].startswith("text/html")
    text = body.decode()
    for needle in ("graph editor", "/object_info", "/events", "/prompt",
                   "buildWorkflow", "widgets_values"):
        assert needle in text, needle
    assert "stable_renderer_tpu graph" not in text  # names the port, not the JAX package


EDITOR_WF = {
    "nodes": [
        {"id": 1, "type": "CheckpointLoaderSimple", "widgets_values": ["x.safetensors"],
         "inputs": []},
        {"id": 2, "type": "CLIPTextEncode", "widgets_values": ["a boat"],
         "inputs": [{"name": "clip", "link": 1}]},
        {"id": 3, "type": "EmptyLatentImage", "widgets_values": [64, 64, 1], "inputs": []},
        {"id": 4, "type": "KSampler",
         "widgets_values": [3, "fixed", 2, 1.5, "euler", "normal", 1.0],
         "inputs": [{"name": "model", "link": 2}, {"name": "positive", "link": 3},
                    {"name": "negative", "link": 4}, {"name": "latent_image", "link": 5}]},
        {"id": 5, "type": "VAEDecode",
         "inputs": [{"name": "samples", "link": 6}, {"name": "vae", "link": 7}]},
        {"id": 6, "type": "InferenceOutput", "inputs": [{"name": "value", "link": 8}]},
    ],
    "links": [[1, 1, 1, 2, 0, "ANY"], [2, 1, 0, 4, 0, "ANY"], [3, 2, 0, 4, 1, "ANY"],
              [4, 2, 0, 4, 2, "ANY"], [5, 3, 0, 4, 3, "ANY"], [6, 4, 0, 5, 0, "ANY"],
              [7, 1, 2, 5, 1, "ANY"], [8, 5, 0, 6, 0, "ANY"]],
}


def test_editor_built_workflow_executes(server):
    base = f"http://127.0.0.1:{server.port}"
    _, out = _post(base + "/prompt", {"prompt": EDITOR_WF})
    serve_workflows(server, max_prompts=1, poll_timeout=0.1, device=CPU)
    hist = json.loads(_get(base + "/history")[1])
    entry = [h for h in hist if h["prompt_id"] == out["prompt_id"]][0]
    assert entry["status"] == "success", entry
    frame = server._frame
    assert frame.dtype == np.uint8 and frame.shape == (16, 16, 3)  # the tiny VAE: x2


def test_scene_hierarchy_and_inspector(server):
    from stable_renderer_tpu_torch.engine.gameobj import GameObject

    base = f"http://127.0.0.1:{server.port}"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/scene")
    assert ei.value.code == 404
    GameObject._clear_scene()
    try:
        parent = GameObject("root-obj", tags=("env",))
        child = GameObject("child-obj")
        child.set_parent(parent)
        child.transform.localPosition = [1.0, 2.0, 3.0]

        class _Eng:  # scene access only needs the class registry
            pass

        eng = _Eng()  # a strong ref: attach_engine keeps a weakref
        server.attach_engine(eng)
        tree = json.loads(_get(base + "/scene")[1])["scene"]
        root = [n for n in tree if n["name"] == "root-obj"][0]
        assert root["tags"] == ["env"]
        kid = root["children"][0]
        assert kid["name"] == "child-obj"
        assert kid["transform"]["position"] == [1.0, 2.0, 3.0]
        assert "Transform" in kid["components"]
        _, out = _post(base + "/scene/update", {"name": "child-obj", "active": False,
                                                "position": [4.0, 5.0, 6.0],
                                                "eulerAngles": [0.0, 90.0, 0.0]})
        assert out["ok"]
        assert not child.active
        assert np.allclose(child.transform.localPosition, [4.0, 5.0, 6.0])
        assert np.allclose(child.transform.localEulerAngles, [0.0, 90.0, 0.0], atol=0.05)
        code, body, _ = _get(base + "/hierarchy")
        assert code == 200 and b"scene hierarchy" in body
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/scene/update", {"name": "nope"})
        assert ei.value.code == 404
    finally:
        GameObject._clear_scene()


def test_unique_node_types_and_type_matchings(server):
    base = f"http://127.0.0.1:{server.port}"
    uniq = json.loads(_get(base + "/unique_node_types")[1])
    assert "InferenceOutput" in uniq and "InferenceOutputNode" in uniq
    tm = json.loads(_get(base + "/type_matchings")[1])
    assert "STRING" in tm.get("ANY", [])
    from stable_renderer_tpu_torch.workflow.executor import NODE_REGISTRY
    from stable_renderer_tpu_torch.workflow.loader import Workflow
    from stable_renderer_tpu_torch.workflow.validation import validate_workflow

    wf = Workflow.from_dict({"nodes": [
        {"id": 1, "type": "EmptyLatentImage", "widgets_values": [64, 64, 1]},
        {"id": 2, "type": "InferenceOutput", "inputs": [{"name": "value", "link": 1}]},
        {"id": 3, "type": "InferenceOutputNode", "inputs": [{"name": "value", "link": 2}]},
    ], "links": [[1, 1, 0, 2, 0, "LATENT"], [2, 1, 0, 3, 0, "LATENT"]]})
    errors = validate_workflow(wf, NODE_REGISTRY)
    assert any(e["type"] == "duplicate_unique_node" for e in errors)


def test_websocket_event_push(server):
    """RFC6455 /ws: handshake, status hello, event relay, ping->pong, close."""
    import base64
    import hashlib

    base_key = base64.b64encode(b"0123456789abcdef").decode()
    s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    try:
        s.sendall((f"GET /ws HTTP/1.1\r\nHost: localhost\r\n"
                   f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {base_key}\r\n"
                   f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(4096)
        head, _, rest = buf.partition(b"\r\n\r\n")
        assert b" 101 " in head.split(b"\r\n")[0]
        expect = base64.b64encode(hashlib.sha1(
            (base_key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest()).decode()
        assert f"Sec-WebSocket-Accept: {expect}".encode() in head

        def read_frame(rest):
            while len(rest) < 2:
                rest += s.recv(4096)
            opcode, ln, off = rest[0] & 0xF, rest[1] & 0x7F, 2
            if ln == 126:
                while len(rest) < 4:
                    rest += s.recv(4096)
                ln, off = int.from_bytes(rest[2:4], "big"), 4
            while len(rest) < off + ln:
                rest += s.recv(4096)
            return opcode, rest[off:off + ln], rest[off + ln:]

        op, payload, rest = read_frame(rest)
        assert op == 1 and json.loads(payload)["type"] == "status"
        server.post_event("progress", {"value": 1, "max": 4})
        for _ in range(5):
            op, payload, rest = read_frame(rest)
            if op == 1:
                break
        msg = json.loads(payload)
        assert msg["type"] == "progress" and msg["data"]["value"] == 1
        mask = b"\x01\x02\x03\x04"
        body = bytes(b ^ mask[i % 4] for i, b in enumerate(b"hi"))
        s.sendall(bytes([0x89, 0x80 | 2]) + mask + body)
        for _ in range(5):
            op, payload, rest = read_frame(rest)
            if op == 0xA:
                break
        assert op == 0xA and payload == b"hi"
        s.sendall(bytes([0x88, 0x80]) + mask)
        for _ in range(5):
            op, payload, rest = read_frame(rest)
            if op == 0x8:
                break
        assert op == 0x8
    finally:
        s.close()


def test_system_stats_endpoint(server):
    code, body, _ = _get(f"http://127.0.0.1:{server.port}/system_stats")
    assert code == 200
    stats = json.loads(body)
    assert "system" in stats and "devices" in stats
    assert stats["system"]["os"]
    for d in stats["devices"]:
        assert {"name", "type", "index", "vram_total", "vram_free"} <= set(d)


def test_queue_management_routes(server):
    base = f"http://127.0.0.1:{server.port}"
    a = server.queue.put({"wf": "a"})
    b = server.queue.put({"wf": "b"})
    c = server.queue.put({"wf": "c"})
    q = json.loads(_get(base + "/queue")[1])
    assert [e[1] for e in q["queue_pending"]] == [a, b, c]
    assert q["queue_running"] == []
    assert json.loads(_get(base + "/prompt")[1])["exec_info"]["queue_remaining"] == 3
    assert _post(base + "/queue", {"delete": [b]})[1]["deleted"] == 1
    q = json.loads(_get(base + "/queue")[1])
    assert [e[1] for e in q["queue_pending"]] == [a, c]
    assert _post(base + "/queue", {"clear": True})[1]["cleared"] == 2
    assert json.loads(_get(base + "/prompt")[1])["exec_info"]["queue_remaining"] == 0


def test_history_item_and_management_routes(server):
    base = f"http://127.0.0.1:{server.port}"
    a = server.queue.put({"wf": "a"})
    b = server.queue.put({"wf": "b"})
    for _ in range(2):
        t = server.queue.get()
        server.queue.task_done(t.prompt_id, "success")
    item = json.loads(_get(base + f"/history/{a}")[1])
    assert item["prompt_id"] == a and item["completed"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/history/9999")
    assert ei.value.code == 404
    assert _post(base + "/history", {"delete": [a]})[1]["deleted"] == 1
    assert {h["prompt_id"] for h in json.loads(_get(base + "/history")[1])} == {b}
    assert _post(base + "/history", {"clear": True})[1]["cleared"] == 1
    assert json.loads(_get(base + "/history")[1]) == []


def test_interrupt_route_and_executor_boundary(server):
    from stable_renderer_tpu_torch.workflow.executor import (
        InterruptProcessingException,
        PromptExecutor,
        interrupt_processing,
        processing_interrupted,
    )
    from stable_renderer_tpu_torch.workflow.loader import Workflow

    base = f"http://127.0.0.1:{server.port}"
    assert not processing_interrupted()
    _, out = _post(base + "/interrupt", {})
    assert out["ok"] and processing_interrupted()
    ex = PromptExecutor(Workflow.from_dict(LATENT_WF), device=CPU)
    with pytest.raises(InterruptProcessingException):
        ex.execute()
    assert not processing_interrupted()  # consumed: the next execute runs clean
    assert ex.execute().final_output is not None
    interrupt_processing(False)


def test_embeddings_route(server, tmp_path):
    (tmp_path / "emb_a.safetensors").write_bytes(b"x")
    sub = tmp_path / "embeddings"
    sub.mkdir()
    (sub / "emb_b.pt").write_bytes(b"x")
    (sub / "not_an_embedding.txt").write_text("x")
    server.model_dirs = (str(tmp_path),)
    names = json.loads(_get(f"http://127.0.0.1:{server.port}/embeddings")[1])
    assert names == ["emb_a", "emb_b"]


def test_view_metadata_route(server, tmp_path):
    base = f"http://127.0.0.1:{server.port}"
    header = json.dumps({
        "__metadata__": {"ss_base_model": "sd15", "format": "pt"},
        "w": {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]},
    }).encode()
    d = tmp_path / "loras"
    d.mkdir()
    (d / "tiny.safetensors").write_bytes(
        len(header).to_bytes(8, "little") + header + b"\x00\x00\x00\x00")
    server.model_dirs = (str(tmp_path),)
    meta = json.loads(_get(base + "/view_metadata/loras?filename=tiny.safetensors")[1])
    assert meta == {"ss_base_model": "sd15", "format": "pt"}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/view_metadata/loras?filename=missing.safetensors")
    assert ei.value.code == 404


def test_free_route_unloads_executor_cache(server):
    server.executor_cache["k"] = object()
    _, out = _post(f"http://127.0.0.1:{server.port}/free", {"unload_models": True})
    assert out["unloaded_executors"] == 1
    assert server.executor_cache == {}


def test_upload_mask_route(server, tmp_path, monkeypatch):
    import stable_renderer_tpu_torch.utils.paths as paths

    monkeypatch.setattr(paths, "OUTPUT_DIR", tmp_path)
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/upload/mask?filename=m.png", data=b"\x89PNG fake",
        headers={"Content-Type": "image/png"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        out = json.loads(r.read())
    assert out["subfolder"] == "input/masks"
    assert (tmp_path / "input" / "masks" / "m.png").read_bytes() == b"\x89PNG fake"


def test_worker_reuses_executor_across_identical_prompts(server):
    base = f"http://127.0.0.1:{server.port}"
    for _ in range(2):
        _post(base + "/prompt", {"prompt": LATENT_WF})
    serve_workflows(server, max_prompts=2, poll_timeout=0.1, device=CPU)
    assert len(server.executor_cache) == 1
    assert [h["status"] for h in json.loads(_get(base + "/history")[1])] == \
        ["success", "success"]


def test_workflows_list_get_and_save(server, tmp_path):
    base = f"http://127.0.0.1:{server.port}"
    server.workflow_save_dir = str(tmp_path / "wfs")
    listing = json.loads(_get(base + "/workflows")[1])
    assert "examples" in listing and "saved" in listing
    wf = {"nodes": [{"id": 1, "type": "EmptyLatentImage", "widgets_values": [8, 8, 1],
                     "pos": [10, 20]}], "links": []}
    assert _post(base + "/workflows/save",
                 {"name": "testgraph", "workflow": wf})[1]["saved"] == "testgraph.json"
    assert "testgraph.json" in json.loads(_get(base + "/workflows")[1])["saved"]
    code, body, _ = _get(base + "/workflows/testgraph.json")
    assert code == 200 and json.loads(body)["nodes"][0]["pos"] == [10, 20]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/workflows/save", {"name": "bad", "workflow": [1, 2]})
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/workflows/absent.json")
    assert ei.value.code == 404
    from stable_renderer_tpu_torch.workflow.loader import Workflow

    assert Workflow.from_dict(json.loads(body)).nodes


def test_editor_page_has_search_and_save_load(server):
    text = _get(f"http://127.0.0.1:{server.port}/editor")[1].decode()
    for needle in ("searchType", "/workflows", "importGraph", "saveWorkflow",
                   "execution_error", "datalist"):
        assert needle in text, needle


def test_editor_groups_reroute_roundtrip(server, tmp_path):
    base = f"http://127.0.0.1:{server.port}"
    server.workflow_save_dir = str(tmp_path / "wfs")
    wf = {
        "nodes": [
            {"id": 1, "type": "EmptyLatentImage", "widgets_values": [8, 8, 1],
             "pos": [10, 20], "inputs": []},
            {"id": 2, "type": "Reroute", "widgets_values": [], "pos": [200, 20],
             "inputs": [{"name": "LATENT", "link": 1}]},
        ],
        "links": [[1, 1, 0, 2, 0, "LATENT"]],
        "groups": [{"title": "latent prep", "bounding": [0, 0, 400, 200],
                    "color": "#3f5159"}],
    }
    assert _post(base + "/workflows/save",
                 {"name": "grouped", "workflow": wf})[1]["saved"] == "grouped.json"
    got = json.loads(_get(base + "/workflows/grouped.json")[1])
    assert got["groups"] == wf["groups"]
    assert any(n["type"] == "Reroute" for n in got["nodes"])
    from stable_renderer_tpu_torch.workflow.executor import NODE_REGISTRY

    assert "Reroute" in NODE_REGISTRY
    page = _get(base + "/editor")[1].decode()
    for feature in ("addGroup", "renderGroups", "function undo", "function redo",
                    "groups:groups.map"):
        assert feature in page, feature


# --- parity with the JAX package's server -----------------------------------------------


@pytest.fixture
def both_servers():
    from stable_renderer_tpu.server import FrameServer as JFrameServer

    js, ps = JFrameServer(port=0).start(), FrameServer(port=0).start()
    yield js, ps
    js.stop()
    ps.stop()


@pytest.mark.parametrize("route", ["/object_info", "/object_info/KSamplerAdvanced",
                                   "/unique_node_types", "/type_matchings"])
def test_introspection_routes_match_jax(both_servers, route):
    js, ps = both_servers
    got = json.loads(_get(f"http://127.0.0.1:{ps.port}{route}")[1])
    want = json.loads(_get(f"http://127.0.0.1:{js.port}{route}")[1])
    assert got == want


ROUNDTRIP_WF = {
    "nodes": [
        {"id": 1, "type": "_TestVAE", "widgets_values": []},
        {"id": 2, "type": "LoadImage", "widgets_values": ["in.png"]},
        {"id": 3, "type": "VAEEncode", "inputs": [{"name": "pixels", "link": 1},
                                                   {"name": "vae", "link": 2}]},
        {"id": 4, "type": "LatentMultiply", "widgets_values": [0.8],
         "inputs": [{"name": "samples", "link": 3}]},
        {"id": 5, "type": "VAEDecode", "inputs": [{"name": "samples", "link": 4},
                                                   {"name": "vae", "link": 5}]},
        {"id": 6, "type": "InferenceOutput", "inputs": [{"name": "value", "link": 6}]},
    ],
    "links": [[1, 2, 0, 3, 0, "IMAGE"], [2, 1, 0, 3, 1, "VAE"], [3, 3, 0, 4, 0, "LATENT"],
              [4, 4, 0, 5, 0, "LATENT"], [5, 1, 0, 5, 1, "VAE"], [6, 5, 0, 6, 0, "IMAGE"]],
}


def test_prompt_through_both_servers_matches_jax(both_servers, monkeypatch, tmp_path,
                                                 request):
    """ROUNDTRIP_WF (a loaded image through a tiny VAE and back) POSTed to
    both servers: the same history status and messages, and the final frame
    each worker publishes within TOL. The VAE's params are the same numbers
    in both (a ``_TestVAE`` node registered in both registries)."""
    import jax.numpy as jnp
    from PIL import Image
    from test_torch_executor import TOL

    import stable_renderer_tpu.models as jmodels
    import stable_renderer_tpu.server as jserver_mod
    import stable_renderer_tpu.workflow.executor as je
    import stable_renderer_tpu_torch.workflow.executor as pe
    from stable_renderer_tpu_torch.models import vae as pvae

    pv = pvae.VAE(pvae.TINY_VAE_CONFIG)
    params = pv.init(torch.Generator().manual_seed(0))

    def as_jax(tree):
        if isinstance(tree, dict):
            return {k: as_jax(v) for k, v in tree.items()}
        return jnp.asarray(tree.numpy())

    jvae = {"vae": jmodels.VAE(jmodels.TINY_VAE_CONFIG), "params": as_jax(params)}
    je.register_node("_TestVAE")(lambda ctx, node: (jvae,))
    pe.register_node("_TestVAE")(lambda ctx, node: ({"vae": pv, "params": params},))
    request.addfinalizer(lambda: [m.NODE_REGISTRY.pop("_TestVAE", None) for m in (je, pe)])

    rgb = (np.random.default_rng(3).uniform(size=(16, 16, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "in.png")
    js, ps = both_servers
    published = {}
    for name, srv in (("jax", js), ("port", ps)):
        real = srv.publish
        monkeypatch.setattr(srv, "publish", lambda f, i=-1, _n=name, _r=real: (
            published.__setitem__(_n, np.array(f, np.float32)), _r(f, i))[1])
    _post(f"http://127.0.0.1:{js.port}/prompt", {"prompt": ROUNDTRIP_WF})
    jserver_mod.serve_workflows(js, model_dirs=(str(tmp_path),), max_prompts=1,
                                poll_timeout=0.1)
    _post(f"http://127.0.0.1:{ps.port}/prompt", {"prompt": ROUNDTRIP_WF})
    serve_workflows(ps, model_dirs=(str(tmp_path),), max_prompts=1, poll_timeout=0.1,
                    device=CPU)
    (jh,), (ph,) = js.queue.get_history(), ps.queue.get_history()
    assert ph["status"] == jh["status"] == "success"
    assert ph["messages"] == jh["messages"]
    assert published["port"].shape == published["jax"].shape == (16, 16, 3)
    assert published["port"].max() > published["port"].min()
    np.testing.assert_allclose(published["port"], published["jax"], **TOL)


# --- the port's own: devices, /free, the CLI, EDITOR mode ----------------------------------


def test_system_stats_and_free_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stats = FrameServer.system_stats()
    assert stats["devices"] == [{"name": "cpu", "type": "cpu", "index": 0,
                                 "vram_total": 0, "vram_free": 0}]
    srv = FrameServer(port=0)
    srv.executor_cache.update(a=1, b=2)
    assert srv.free(free_memory=True) == {"unloaded_executors": 0, "freed_bytes": 0}
    assert srv.executor_cache == {}


def test_system_stats_lists_each_card_and_raises_on_a_failed_query(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card {i}")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (10 + i, 80))
    assert FrameServer.system_stats()["devices"] == [
        {"name": f"card {i}", "type": "cuda", "index": i, "vram_total": 80,
         "vram_free": 10 + i} for i in range(2)]

    def broken(i):
        raise RuntimeError("CUDA error: device unavailable")

    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    with pytest.raises(RuntimeError, match="device unavailable"):
        FrameServer.system_stats()


def test_serve_workflows_needs_a_card_unless_asked_for_the_cpu(monkeypatch, server):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    server.queue.put(LATENT_WF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_workflows(server, max_prompts=1, poll_timeout=0.1)
    assert server.queue.get_history() == []  # raised before taking the prompt
    serve_workflows(server, max_prompts=1, poll_timeout=0.1, device=CPU)
    assert [h["status"] for h in server.queue.get_history()] == ["success"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_answers_a_prompt_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``serve --max-prompts 1 --device cpu``: a client thread reads
    /system_stats, subscribes to /events and POSTs EDITOR_WF with a SaveImage
    once the server answers, then reads the events up to the prompt's
    ``executed``. The command returns 0 after the prompt, the saved frame is
    on disk, and the kernels' launches are printed (none on the CPU)."""
    import stable_renderer_tpu_torch.cli as pcli
    import stable_renderer_tpu_torch.utils.paths as paths

    monkeypatch.setattr(paths, "OUTPUT_DIR", tmp_path)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    wf = json.loads(json.dumps(EDITOR_WF))
    wf["nodes"].append({"id": 7, "type": "SaveImage", "widgets_values": ["x"],
                        "inputs": [{"name": "images", "link": 9}]})
    wf["links"].append([9, 5, 0, 7, 0, "IMAGE"])
    seen = {"events": []}

    def client():
        for _ in range(100):
            try:
                _get(base + "/status")
                break
            except OSError:
                time.sleep(0.05)
        seen["stats"] = json.loads(_get(base + "/system_stats")[1])
        # subscribed once the headers are back: no event of the prompt is missed
        with urllib.request.urlopen(base + "/events", timeout=10) as sse:
            seen["pid"] = _post(base + "/prompt", {"prompt": wf})[1]["prompt_id"]
            for line in sse:
                if line.startswith(b"data: "):
                    evt = json.loads(line[6:])
                    seen["events"].append(evt)
                    if evt["type"] == "executed":
                        break

    t = threading.Thread(target=client, daemon=True)
    t.start()
    assert pcli.main(["serve", "--port", str(port), "--max-prompts", "1",
                      "--device", "cpu"]) == 0
    t.join(timeout=5)
    out = capsys.readouterr().out
    assert f"viewer: http://127.0.0.1:{port}/" in out
    assert 'kernel launches over 1 successful prompts: {"flash_attention": 0' in out
    assert seen["stats"]["devices"][0]["type"] in ("cpu", "cuda")
    done = [e["data"] for e in seen["events"] if e["type"] == "executed"]
    assert done == [{"prompt_id": seen["pid"], "status": "success"}]
    img = _png((tmp_path / "workflow" / "frame_0.png").read_bytes())
    assert img.shape == (16, 16, 3)


def test_cli_serve_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import stable_renderer_tpu_torch.cli as pcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["serve", "--port", "0", "--max-prompts", "1"])


def test_run_editor_streams_frames_and_the_scene():
    """Engine.RunEditor on the CPU: the editor server gets every presented
    frame (/frame.png is the last, /stream sends it), /scene lists the ball,
    and the server outlives the loop until stopped."""
    from stable_renderer_tpu_torch.engine.engine import Engine, EngineMode

    Engine._reset()
    seen = []
    eng = _ball_app(Engine).RunEditor(winSize=(48, 48), disableComfyUI=True, max_frames=3,
                                      device=CPU, editor_port=0,
                                      frame_callback=lambda f, i: seen.append(i))
    try:
        assert eng.Mode == EngineMode.EDITOR and seen == [0, 1, 2]
        base = f"http://127.0.0.1:{eng.editor_server.port}"
        img = _png(_get(base + "/frame.png")[1])
        assert img.shape == (48, 48, 3) and img.max() > 100
        assert json.loads(_get(base + "/status")[1])["frame"] == 2
        got = {}
        t = threading.Thread(target=_read_stream, args=(base, got, 1), daemon=True)
        t.start()
        t.join(timeout=5)
        assert b"image/jpeg" in got["data"]
        names = [n["name"] for n in json.loads(_get(base + "/scene")[1])["scene"]]
        assert "ball" in names and "cam" in names
    finally:
        eng.editor_server.stop()
        Engine._reset()


def test_cli_render_editor_runs_and_stops_its_server(tmp_path, capsys):
    import stable_renderer_tpu_torch.cli as pcli
    from stable_renderer_tpu_torch.engine.engine import Engine

    Engine._reset()
    assert pcli.main(["render", "--no-diffusion", "--size", "32", "--frames", "2", "--editor",
                      "--editor-port", "0", "--device", "cpu", "--out", str(tmp_path)]) == 0
    Engine._reset()
    out = capsys.readouterr().out
    assert "editor: served at http://127.0.0.1:" in out
    port = int(out.split("editor: served at http://127.0.0.1:")[1].split("/")[0])
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{port}/status")
    assert len(list(tmp_path.glob("frame_*.png"))) == 2


def test_editor_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from stable_renderer_tpu_torch.engine.engine import Engine, EngineMode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Engine._reset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(mode=EngineMode.EDITOR, editor_port=0)
    Engine._reset()
