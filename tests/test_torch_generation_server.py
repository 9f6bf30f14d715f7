"""The port's GenerationServer (POST /generate over its ContinuousBatcher)
against the JAX package's, both launched through their CLIs'
`--mode=serve` with serve_continuous=true on one tiny GPT-2 directory (a
byte-level BPE vocabulary, a 2-layer config, HF-named weights made with
numpy from a seed: tests/test_torch_sequence_generation.py's
make_model_dir). Both run in f32 on the CPU; the same greedy requests must
give the same `output_ids` and text, blocking and streamed, and the same
status on bad requests."""

import http.client
import json
import os
import subprocess
import sys
import threading

import pytest

from tests.test_serving import _get, _post
from tests.test_torch_sequence_generation import make_model_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UDP = ("serve_continuous=true serve_blocking=False serve_port=0 "
       "serve_slots=2 serve_chunk_size=4 serve_prompt_buckets=16 "
       "serve_max_new_tokens=6")
TEXTS = ["the model then", "an other token", "here there", "on"]


def _post_stream(port, payload):
    """POST /generate with stream=true: (status, NDJSON events) read off the
    chunked response."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, json.loads(resp.read())
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        events = []
        while True:
            line = resp.readline()
            if not line:
                break
            events.append(json.loads(line))
        return resp.status, events
    finally:
        conn.close()


def _port_argv(model_dir, udp=UDP):
    return ["--mode=serve", "--checkpoint_dir=" + model_dir,
            "--sequence_length=48", "--dtype=float32", "--device=cpu",
            "--user_defined_parameters=" + udp]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(port server, JAX server, model dir), each from its CLI's
    default_main_fn."""
    from easynlp_tpu.appzoo.api import default_main_fn as jax_main
    from easynlp_tpu.testing import make_args
    from easynlp_tpu.utils import global_vars
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    model_dir = str(tmp_path_factory.mktemp("gen_server") / "model")
    make_model_dir(model_dir)
    saved = global_vars._GLOBAL_ARGS
    jax_srv = jax_main(make_args(
        mode="serve", checkpoint_dir=model_dir, sequence_length=48,
        dtype="float32", user_defined_parameters_dict=dict(
            kv.split("=") for kv in UDP.split())))
    global_vars._GLOBAL_ARGS = saved
    srv = default_main_fn(initialize_easynlp(args_list=_port_argv(model_dir)))
    yield srv, jax_srv, model_dir
    srv.stop()
    jax_srv.stop()


def _both(servers, payload):
    srv, jax_srv, _ = servers
    return (_post(srv.port, payload, path="/generate"),
            _post(jax_srv.port, payload, path="/generate"))


@pytest.mark.parametrize("payload", [
    {"prompt_ids": [40, 71, 72, 79, 3], "max_new_tokens": 9},
    {"prompts": [[40, 71], [3, 80, 81, 82, 83, 84, 85], [5]],
     "max_new_tokens": [4, 11, 7]},
    {"text": TEXTS[0]},
    {"texts": TEXTS, "max_new_tokens": 10},
], ids=["ids", "batch", "text", "texts"])
def test_generate_matches_jax(servers, payload):
    """Greedy /generate, single and batch, ids and text: the port's response
    equals the JAX server's (output_ids, and text through each package's
    GPT-2 tokenizer)."""
    (status, body), (jax_status, jax_body) = _both(servers, payload)
    assert status == jax_status == 200, (body, jax_body)
    assert body == jax_body
    outs = body.get("outputs") or [body["output_ids"]]
    assert all(outs)


def test_stream_matches_jax_and_blocking(servers):
    """A streamed text request: its tokens equal the blocking response's and
    the JAX stream's; concatenated deltas rebuild the final text, which
    equals JAX's."""
    srv, jax_srv, _ = servers
    req = {"text": TEXTS[1], "max_new_tokens": 12}
    status, body = _post(srv.port, req, path="/generate")
    assert status == 200, body
    streams = [_post_stream(s.port, dict(req, stream=True))
               for s in (srv, jax_srv)]
    for st, events in streams:
        assert st == 200, events
        done = events[-1]
        assert done["done"] is True
        assert [e["token"] for e in events[:-1]] == done["output_ids"]
        assert "".join(e.get("text_delta", "") for e in events) == \
            done["text"]
    assert streams[0][1][-1] == streams[1][1][-1]
    assert streams[0][1][-1]["output_ids"] == body["output_ids"]
    assert streams[0][1][-1]["text"] == body["text"]


def test_sampled_batch_matches_device_decoder(servers):
    """Mixed greedy/sampled requests over HTTP equal the port's
    DeviceContinuousDecoder for the same (prompt, seed); the same sampled
    request sent again, with other co-tenants, gives the same tokens."""
    from easynlp_tpu_torch.serving import DeviceContinuousDecoder
    srv, _, _ = servers
    payload = {"prompts": [[3, 1, 4], [9, 2, 6, 5], [7], [8, 8, 8]],
               "max_new_tokens": 10,
               "do_sample": [False, True, True, True],
               "temperature": [1.0, 0.7, 1.3, 0.9],
               "top_k": [0, 5, 0, 3], "top_p": [1.0, 1.0, 0.9, 0.95],
               "seed": [0, 11, 22, 33]}
    status, body = _post(srv.port, payload, path="/generate")
    assert status == 200, body
    b = srv.batcher
    dec = DeviceContinuousDecoder(b.model, max_slots=3, max_length=48,
                                  prompt_bucket=16, eos_token_id=b.eos,
                                  pad_token_id=b.pad, chunk_size=5)
    kw = {k: payload[k] for k in ("do_sample", "temperature", "top_k",
                                  "top_p", "seed")}
    assert dec(payload["prompts"], 10, **kw) == body["outputs"]
    again = {"prompt_ids": payload["prompts"][2], "max_new_tokens": 10,
             "do_sample": True, "temperature": 1.3, "top_p": 0.9, "seed": 22}
    status, one = _post(srv.port, again, path="/generate")
    assert one["output_ids"] == body["outputs"][2]


@pytest.mark.parametrize("payload,path", [
    ({"prompt_ids": list(range(1, 30))}, "/generate"),
    ({"max_new_tokens": 4}, "/generate"),
    ({"prompts": [[1, 2], [3, 4]], "seed": [1]}, "/generate"),
    ({"prompts": [[]]}, "/generate"),
    ({"prompt_ids": [1]}, "/nope"),
], ids=["over-bucket", "no-prompt", "list-length", "empty", "404"])
def test_bad_requests_match_jax(servers, payload, path):
    """Bad requests get the JAX server's status (400, or 404 off the path)
    and the server goes on serving."""
    srv, jax_srv, _ = servers
    status, body = _post(srv.port, payload, path=path)
    jax_status, _ = _post(jax_srv.port, payload, path=path)
    assert status == jax_status and status in (400, 404), body
    assert "error" in body
    if payload.get("prompts") == [[1, 2], [3, 4]]:
        assert "entries" in body["error"]
    status, body = _post(srv.port, {"prompt_ids": [5, 6, 7]},
                         path="/generate")
    assert status == 200 and body["output_ids"]


def test_info_health_and_stream_rejects_batch(servers):
    srv, _, model_dir = servers
    status, body = _get(srv.port, "/health")
    assert status == 200 and body["status"] == "ok"
    status, body = _get(srv.port, "/info")
    assert status == 200 and body["mode"] == "continuous"
    assert body["slots"] == 2 and body["max_length"] == 48
    assert body["prompt_buckets"] == [16] and body["model"] == model_dir
    assert srv.timings and all(0 <= first <= last and n >= 1
                               for first, last, n in srv.timings)
    status, body = _post_stream(srv.port, {"prompts": [[1, 2], [3, 4]],
                                           "stream": True})
    assert status == 400 and "single prompt" in body["error"]


def test_dead_batcher_is_503(servers):
    """A stopped (dead) batcher answers 503, blocking and streamed."""
    from easynlp_tpu_torch.serving import ContinuousBatcher, GenerationServer
    b = ContinuousBatcher(servers[0].batcher.model, max_slots=2,
                          max_length=32, prompt_buckets=(16,),
                          pad_token_id=0, chunk_size=4)
    srv = GenerationServer(b, port=0).start()
    try:
        b.stop()
        status, body = _post(srv.port, {"prompt_ids": [1, 2]},
                             path="/generate")
        assert status == 503, (status, body)
        status, body = _post_stream(srv.port, {"prompt_ids": [1, 2],
                                               "stream": True})
        assert status == 503, (status, body)
    finally:
        srv.stop(stop_batcher=False)


class _FixedBatcher:
    """A batcher stand-in that streams a fixed token list."""
    slots, max_length, buckets = 1, 64, (16,)

    def __init__(self, pending_cls, tokens):
        self.pending_cls, self.tokens = pending_cls, tokens

    def submit(self, ids, max_new_tokens=32, stream=False, **_):
        req = self.pending_cls(ids, max_new_tokens, stream=stream)
        for tok in self.tokens:
            req.push(tok)
        req.close()
        return req


def _byte_ids(tokenizer, data):
    """The ids of the single-byte tokens spelling `data`."""
    enc = {v: k for k, v in tokenizer.byte_decoder.items()}
    return [tokenizer.convert_tokens_to_ids([enc[b]])[0] for b in data]


def test_genuine_replacement_char_is_flushed_unlike_jax(servers):
    """ROADMAP C6: the model emits "a", then U+FFFD spelled as its three
    bytes EF BF BD, then the first byte of "é". The JAX server holds the
    genuine U+FFFD back until the done event (it strips every trailing
    U+FFFD); the port's byte-level check sends it with its third byte and
    holds back only the incomplete tail. Both end on the same text."""
    from easynlp_tpu.modelzoo.models.gpt2.tokenization_gpt2 import (
        GPT2Tokenizer as JaxGPT2Tokenizer)
    from easynlp_tpu.serving import continuous as jax_continuous
    from easynlp_tpu.serving.server import (
        GenerationServer as JaxGenerationServer)
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
    from easynlp_tpu_torch.serving import continuous as C
    from easynlp_tpu_torch.serving.server import GenerationServer
    model_dir = servers[2]
    tok = GPT2Tokenizer.from_pretrained(model_dir)
    ids = _byte_ids(tok, b"a\xef\xbf\xbd" + "é".encode()[:1])
    deltas = {}
    for name, server_cls, pending, tokenizer in (
            ("port", GenerationServer, C._Pending, tok),
            ("jax", JaxGenerationServer, jax_continuous._Pending,
             JaxGPT2Tokenizer.from_pretrained(model_dir))):
        srv = server_cls(_FixedBatcher(pending, ids), tokenizer=tokenizer)
        events = list(srv._stream_events({"prompt_ids": [1]}))
        deltas[name] = [e.get("text_delta") for e in events]
        assert events[-1]["text"] == "a\ufffd\ufffd"
    assert deltas["jax"] == ["a", None, None, None, None, "\ufffd\ufffd"]
    assert deltas["port"] == ["a", None, None, "\ufffd", None, "\ufffd"]


def test_cli_serve_imports_no_jax(servers):
    """`python -m easynlp_tpu_torch.cli --mode=serve` with
    serve_continuous=true in a fresh process: it answers /generate (a
    streamed text request too) and loads no jax, flax or easynlp_tpu
    module."""
    code = (
        "import json, sys, urllib.request\n"
        "from easynlp_tpu_torch.appzoo.api import default_main_fn\n"
        "from easynlp_tpu_torch.utils.initializer import initialize_easynlp\n"
        "srv = default_main_fn(initialize_easynlp(args_list=%r))\n"
        "def post(payload):\n"
        "    req = urllib.request.Request('http://127.0.0.1:%%d/generate' %% "
        "srv.port, data=json.dumps(payload).encode())\n"
        "    with urllib.request.urlopen(req, timeout=60) as r:\n"
        "        return r.read().decode()\n"
        "body = json.loads(post({'text': 'the model', "
        "'max_new_tokens': 5}))\n"
        "assert len(body['output_ids']) >= 1, body\n"
        "lines = post({'text': 'the model', 'stream': True}).splitlines()\n"
        "assert json.loads(lines[-1])['done'] is True\n"
        "srv.stop()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'easynlp_tpu')"
        " or m.startswith('easynlp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n" % (_port_argv(servers[2]),))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_concurrent_clients(servers):
    """8 client threads at once over 2 slots: each greedy response equals
    the same request sent alone."""
    srv = servers[0]
    prompts = [[i + 1, 2 * i + 3, 40] for i in range(8)]
    alone = [_post(srv.port, {"prompt_ids": p, "max_new_tokens": 5 + i},
                   path="/generate")[1]["output_ids"]
             for i, p in enumerate(prompts)]
    got = [None] * 8

    def fire(i):
        got[i] = _post(srv.port, {"prompt_ids": prompts[i],
                                  "max_new_tokens": 5 + i},
                       path="/generate")[1]["output_ids"]
    threads = [threading.Thread(target=fire, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert got == alone


def test_int8_serving_matches_jax(servers):
    """serve_quantize=int8 on the continuous route, both CLIs, f32: the
    port's batcher holds int8 weights (the tensors JAX quantizes) and its
    greedy /generate equals the JAX server's, batch and text."""
    from easynlp_tpu.appzoo.api import default_main_fn as jax_main
    from easynlp_tpu.testing import make_args
    from easynlp_tpu.utils import global_vars
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.modelzoo.quantization import quantization_report
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    model_dir = servers[2]
    udp = UDP + " serve_quantize=int8"
    saved = global_vars._GLOBAL_ARGS
    jax_srv = jax_main(make_args(
        mode="serve", checkpoint_dir=model_dir, sequence_length=48,
        dtype="float32", user_defined_parameters_dict=dict(
            kv.split("=") for kv in udp.split())))
    global_vars._GLOBAL_ARGS = saved
    srv = default_main_fn(initialize_easynlp(args_list=_port_argv(model_dir,
                                                                  udp)))
    try:
        assert quantization_report(srv.batcher.model)[2] == 6
        for payload in ({"prompts": [[40, 71], [3, 80, 81, 82, 83, 84, 85],
                                     [5]], "max_new_tokens": [4, 11, 7]},
                        {"texts": TEXTS, "max_new_tokens": 10}):
            (status, body), (jax_status, jax_body) = (
                _post(srv.port, payload, path="/generate"),
                _post(jax_srv.port, payload, path="/generate"))
            assert status == jax_status == 200, (body, jax_body)
            assert body == jax_body
    finally:
        srv.stop()
        jax_srv.stop()
