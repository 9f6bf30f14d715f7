"""Dependency-free HTTP serving for the PyTorch port.

Counterpart of easynlp_tpu/serving/server.py, with the same endpoints and
error contract:

PredictionServer (over pipeline(), dynamic micro-batching):
    GET  /health            -> {"status": "ok"}
    GET  /info              -> task / model_path / batching config
    POST /predict           -> {"inputs": [...]} or {"input": ...};
                               pair inputs as 2-element lists.
                               Response: {"outputs": [...]} (or {"output"}).
Requests land in a queue; one worker thread drains up to `max_batch_size`
inputs (waiting at most `max_delay_ms` after the first arrival) and runs
them through the pipeline in ONE call. JSON-unserialisable outputs (numpy
arrays, tensors) are converted via .tolist().

GenerationServer (over a ContinuousBatcher): POST /generate, see its
docstring. Two differences from the JAX servers: a streamed U+FFFD that the
model really emitted is sent at once, and only an incomplete multi-byte
tail is held back (ROADMAP C6); and both servers listen with a backlog of
1024 connections, where the standard library's 5 resets some of a burst of
concurrent clients.
"""

import codecs
import collections
import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from easynlp_tpu_torch.utils.logger import logger


def _jsonable(x):
    if hasattr(x, "detach") and hasattr(x, "cpu"):  # a torch tensor
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, bytes):
        import base64
        return base64.b64encode(x).decode()
    return x


class _HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog for many concurrent
    clients: the standard library's 5 resets connections once a burst of
    clients outruns the accept loop."""
    request_queue_size = 1024
    daemon_threads = True


class _Request:
    __slots__ = ("inputs", "event", "result", "error")

    def __init__(self, inputs):
        self.inputs = inputs
        self.event = threading.Event()
        self.result = None
        self.error = None


class PredictionServer:
    """Serve a Pipeline (or any callable mapping list→list) over HTTP."""

    def __init__(self, pipeline, host="127.0.0.1", port=8080,
                 max_batch_size=32, max_delay_ms=5.0, info=None,
                 request_timeout_s=600.0):
        self.pipeline = pipeline
        self.host, self.port = host, port
        self.max_batch_size = int(max_batch_size)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        # generous default: a generation pipeline's batch can take minutes
        # on the CPU
        self.request_timeout_s = float(request_timeout_s)
        self.info = dict(info or {})
        self.info.setdefault("max_batch_size", self.max_batch_size)
        self.info.setdefault("max_delay_ms", float(max_delay_ms))
        self._queue = queue.Queue()
        self._holdover = None  # request deferred to keep a batch <= max
        self._stop = threading.Event()
        self._worker = None
        self._httpd = None
        self.stats = {"requests": 0, "examples": 0, "batches": 0,
                      "errors": 0}

    # ---------------- batching worker ----------------

    def _drain_batch(self):
        """Block for the first request, then coalesce for up to max_delay."""
        if self._holdover is not None:
            first, self._holdover = self._holdover, None
        else:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return []
        batch = [first]
        total = len(first.inputs)
        deadline = time.monotonic() + self.max_delay_s
        while total < self.max_batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if total + len(req.inputs) > self.max_batch_size:
                # would overshoot the batch contract — lead the next batch
                self._holdover = req
                break
            batch.append(req)
            total += len(req.inputs)
        return batch

    def _worker_loop(self):
        while not self._stop.is_set():
            batch = self._drain_batch()
            if not batch:
                continue
            flat = [x for req in batch for x in req.inputs]
            try:
                outs = self.pipeline(flat)
                if not isinstance(outs, list) or len(outs) != len(flat):
                    raise ValueError(
                        "pipeline returned %r for %d inputs"
                        % (type(outs), len(flat)))
                pos = 0
                for req in batch:
                    req.result = outs[pos:pos + len(req.inputs)]
                    pos += len(req.inputs)
                self.stats["batches"] += 1
                self.stats["examples"] += len(flat)
            except Exception as e:  # surface per-request, keep serving
                logger.exception("serving batch failed")
                self.stats["errors"] += 1
                for req in batch:
                    req.error = str(e)
            for req in batch:
                req.event.set()

    # ---------------- request handling ----------------

    def submit(self, inputs, timeout=None):
        timeout = self.request_timeout_s if timeout is None else timeout
        req = _Request(inputs)
        self._queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("prediction timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *fargs):  # route through our logger
                logger.debug("serving: " + fmt, *fargs)

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok"})
                elif self.path == "/info":
                    self._send(200, dict(server.info, stats=server.stats))
                else:
                    self._send(404, {"error": "unknown path %s" % self.path})

            def do_POST(self):
                if self.path != "/predict":
                    # drain the body: HTTP/1.1 keep-alive would otherwise
                    # parse the unread bytes as the next request line
                    length = int(self.headers.get("Content-Length", 0))
                    if length:
                        self.rfile.read(length)
                    self._send(404, {"error": "unknown path %s" % self.path})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    single = "input" in payload and "inputs" not in payload
                    inputs = ([payload["input"]] if single
                              else payload.get("inputs"))
                    if not isinstance(inputs, list) or not inputs:
                        self._send(400, {"error":
                                         "provide 'inputs': [...] or 'input'"})
                        return
                    # pair inputs arrive as 2-element lists → tuples
                    inputs = [tuple(x) if isinstance(x, list) else x
                              for x in inputs]
                    server.stats["requests"] += 1
                    outs = _jsonable(server.submit(inputs))
                    self._send(200, {"output": outs[0]} if single
                               else {"outputs": outs})
                except Exception as e:
                    self._send(500, {"error": str(e)})

        return Handler

    # ---------------- lifecycle ----------------

    def start(self):
        """Start worker + HTTP server (non-blocking). Returns self."""
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()
        self._httpd = _HTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]  # resolve port=0
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        logger.info("serving on http://%s:%d (max_batch=%d, max_delay=%.1fms)",
                    self.host, self.port, self.max_batch_size,
                    self.max_delay_s * 1e3)
        return self

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._worker is not None:
            self._worker.join(timeout=5)

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.stop()


class GenerationServer:
    """HTTP front-end over a ContinuousBatcher: every request joins the
    shared continuous decode loop, so concurrent generations interleave at
    token granularity (short requests drain early, slots refill) instead of
    coalescing into fixed batches like PredictionServer. Per-request
    sampling params ride through to the batcher — a sampled output is a
    pure function of (prompt, seed) regardless of co-tenants.

    Endpoints:
        GET  /health    → {"status": "ok"}
        GET  /info      → slots / max_length / prompt_buckets / stats
        POST /generate  → single: {"prompt_ids": [...], ...params}
                          batch:  {"prompts": [[...], ...], ...params}
                          (with a tokenizer: "text" / "texts" instead)
                          params: max_new_tokens, do_sample, temperature,
                          top_k, top_p, seed — scalar, or per-request list
                          in batch mode.
                          Response: {"output_ids": [...]} /
                          {"outputs": [[...], ...]} (+ "text"/"texts" when
                          a tokenizer is attached).
                          "stream": true (single prompt only) switches the
                          response to chunked application/x-ndjson: one
                          {"token": id[, "text_delta": s]} event per
                          committed token, then {"done": true,
                          "output_ids": [...][, "text": s]}; mid-stream
                          failures end the stream with {"error": ...}.

    Threading: ThreadingHTTPServer gives each request its own handler
    thread, which submits straight to the batcher and blocks on its result
    — the batcher IS the coalescer, so no server-side batching worker
    exists. Bad requests (prompt over the largest bucket, malformed JSON)
    → 400; a dead batcher scheduler → 503 with the cause.
    """

    def __init__(self, batcher, host="127.0.0.1", port=8080, tokenizer=None,
                 default_max_new_tokens=32, request_timeout_s=600.0,
                 info=None):
        self.batcher = batcher
        self.host, self.port = host, port
        self.tokenizer = tokenizer
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.request_timeout_s = float(request_timeout_s)
        self.info = dict(info or {})
        self.info.setdefault("slots", batcher.slots)
        self.info.setdefault("max_length", batcher.max_length)
        self.info.setdefault("prompt_buckets", list(batcher.buckets))
        self.stats = {"requests": 0, "generated_tokens": 0, "errors": 0}
        # per finished request: (seconds to the first token, seconds to the
        # last, tokens), host clock from submit; the newest 10000
        self.timings = collections.deque(maxlen=10000)
        self._httpd = None

    # ---------------- request handling ----------------

    def _encode(self, text):
        """Raw prompt ids — no special tokens, no padding (the batcher
        left-pads to its prompt bucket itself). Supports both HF-style
        .encode() and this repo's tokenize/convert_tokens_to_ids base."""
        tok = self.tokenizer
        if hasattr(tok, "encode"):
            return list(tok.encode(text))
        return list(tok.convert_tokens_to_ids(tok.tokenize(text)))

    def _parse(self, payload):
        """→ (prompt_id_lists, per-request param dicts, single?)."""
        single = False
        if "prompt_ids" in payload:
            prompts, single = [payload["prompt_ids"]], True
        elif "prompts" in payload:
            prompts = payload["prompts"]
        elif "text" in payload or "texts" in payload:
            if self.tokenizer is None:
                raise ValueError(
                    "this server has no tokenizer; send 'prompt_ids' or "
                    "'prompts' (token ids)")
            single = "text" in payload
            texts = [payload["text"]] if single else payload["texts"]
            prompts = [self._encode(t) for t in texts]
        else:
            raise ValueError(
                "provide 'prompt_ids', 'prompts', 'text', or 'texts'")
        if (not isinstance(prompts, list) or not prompts
                or not all(isinstance(p, list) and p for p in prompts)):
            raise ValueError("prompts must be non-empty lists of token ids")
        n = len(prompts)

        def per_req(name, default, cast):
            v = payload.get(name, default)
            if isinstance(v, list):
                if len(v) != n:
                    raise ValueError(
                        "%s has %d entries for %d prompts"
                        % (name, len(v), n))
                return [cast(x) for x in v]
            return [cast(v)] * n

        params = {
            "max_new_tokens": per_req("max_new_tokens",
                                      self.default_max_new_tokens, int),
            "do_sample": per_req("do_sample", False, bool),
            "temperature": per_req("temperature", 1.0, float),
            "top_k": per_req("top_k", 0, int),
            "top_p": per_req("top_p", 1.0, float),
            "seed": per_req("seed", 0, int),
        }
        return prompts, params, single

    def _record(self, handle):
        first = getattr(handle, "first_token", None)
        if first is not None:
            now = time.perf_counter()
            self.timings.append((first - handle.submitted,
                                 now - handle.submitted, len(handle.tokens)))

    def _stable_text(self, toks):
        """The decoded text of `toks` that later tokens cannot change. A
        byte-level tokenizer (one with `byte_decoder`) can say whether its
        bytes end in an INCOMPLETE UTF-8 sequence, which decode shows as a
        trailing U+FFFD: only that one is held back until later tokens
        complete it, and a U+FFFD the model really emitted goes out at once.
        (The JAX server holds back every trailing U+FFFD until the done
        event, ROADMAP C6.) Without byte information a trailing U+FFFD run
        cannot be told apart, so it is held back as in the JAX server."""
        tok = self.tokenizer
        full = tok.decode(toks)
        if not full.endswith("\ufffd"):
            return full
        byte_decoder = getattr(tok, "byte_decoder", None)
        if byte_decoder is None:
            return full.rstrip("\ufffd")
        pieces = tok.convert_ids_to_tokens(toks, skip_special_tokens=True)
        data = bytes(byte_decoder[c] for piece in pieces for c in piece
                     if c in byte_decoder)
        decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        decoder.decode(data, final=False)
        pending = decoder.getstate()[0]
        return full[:-1] if pending else full

    def _generate(self, payload):
        prompts, params, single = self._parse(payload)
        # submit everything first so the batcher interleaves the whole
        # request set, then block for results in order
        handles = [
            self.batcher.submit(
                ids, max_new_tokens=params["max_new_tokens"][i],
                do_sample=params["do_sample"][i],
                temperature=params["temperature"][i],
                top_k=params["top_k"][i], top_p=params["top_p"][i],
                seed=params["seed"][i])
            for i, ids in enumerate(prompts)
        ]
        try:
            outs = [h.result(timeout=self.request_timeout_s)
                    for h in handles]
        except TimeoutError:
            # don't leave abandoned generations burning decode slots
            for h in handles:
                h.cancel()
            raise
        self.stats["requests"] += len(prompts)
        self.stats["generated_tokens"] += sum(len(o) for o in outs)
        for h in handles:
            self._record(h)
        resp = ({"output_ids": outs[0]} if single else {"outputs": outs})
        if self.tokenizer is not None:
            texts = [self.tokenizer.decode(o) for o in outs]
            resp["text" if single else "texts"] = (texts[0] if single
                                                   else texts)
        return resp

    def _stream_events(self, payload):
        """Generator of NDJSON events for `"stream": true` requests: one
        `{"token": id[, "text_delta": s]}` per committed token, then a
        final `{"done": true, "output_ids": [...][, "text": s]}`.

        Pre-stream failures (bad request, dead scheduler) raise out of the
        FIRST next() — before any bytes hit the wire — so the handler can
        still answer with a proper 400/503 status."""
        prompts, params, single = self._parse(payload)
        if not single:
            raise ValueError(
                "stream=true supports a single prompt only ('prompt_ids' "
                "or 'text'); send batch requests without streaming")
        handle = self.batcher.submit(
            prompts[0], max_new_tokens=params["max_new_tokens"][0],
            do_sample=params["do_sample"][0],
            temperature=params["temperature"][0],
            top_k=params["top_k"][0], top_p=params["top_p"][0],
            seed=params["seed"][0], stream=True)
        toks, text = [], ""
        try:
            it = handle.iter_tokens(timeout=self.request_timeout_s)
            # fetch the first token before the first yield: the handler's
            # initial next() then surfaces a dead scheduler as an exception
            # BEFORE the 200 header is committed to the wire
            try:
                first = next(it)
            except StopIteration:
                first = None
            if first is not None:
                for tok in itertools.chain([first], it):
                    toks.append(tok)
                    ev = {"token": tok}
                    if self.tokenizer is not None:
                        # decode cumulatively and emit the delta: per-token
                        # decode would split multi-piece characters
                        stable = self._stable_text(toks)
                        if not stable.startswith(text):
                            # decode REWROTE already-emitted characters:
                            # resend cumulatively with a replace marker so
                            # concatenating clients can resynchronise
                            ev["text"] = stable
                            ev["replace"] = True
                            text = stable
                        elif len(stable) > len(text):
                            ev["text_delta"] = stable[len(text):]
                            text = stable
                        # else: held back: token event without text fields
                    yield ev
        finally:
            # a consumer that stops early (client disconnect → the handler
            # close()s this generator) must not leave the generation
            # burning a decode slot; no-op once the request resolved
            handle.cancel()
        self.stats["requests"] += 1
        self.stats["generated_tokens"] += len(toks)
        self._record(handle)
        done = {"done": True, "output_ids": toks}
        if self.tokenizer is not None:
            # authoritative final decode: a tail still held back (a byte
            # sequence the generation left incomplete) lands here, as a
            # final text_delta when it extends the emitted text cleanly
            full = self.tokenizer.decode(toks) if toks else text
            if full.startswith(text) and len(full) > len(text):
                done["text_delta"] = full[len(text):]
            done["text"] = full
        yield done

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *fargs):
                logger.debug("serving: " + fmt, *fargs)

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok"})
                elif self.path == "/info":
                    self._send(200, dict(server.info, stats=server.stats))
                else:
                    self._send(404, {"error": "unknown path %s" % self.path})

            def _chunk(self, obj):
                """One NDJSON event as an HTTP/1.1 chunked-encoding chunk
                (flushed immediately so clients see tokens as they land)."""
                data = json.dumps(_jsonable(obj)).encode() + b"\n"
                self.wfile.write(b"%x\r\n" % len(data))
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            def _stream(self, payload):
                gen = server._stream_events(payload)
                # the first next() runs parse + submit + first-token fetch,
                # so every pre-stream failure still gets a real status code
                try:
                    first_ev = next(gen)
                except ValueError as e:
                    server.stats["errors"] += 1
                    self._send(400, {"error": str(e)})
                    return
                except (RuntimeError, TimeoutError) as e:
                    server.stats["errors"] += 1
                    self._send(503, {"error": str(e)})
                    return
                except Exception as e:
                    server.stats["errors"] += 1
                    self._send(500, {"error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    self._chunk(first_ev)
                    for ev in gen:
                        self._chunk(ev)
                except OSError:
                    # client went away mid-stream: close the generator NOW
                    # so its finally-cancel frees the decode slot promptly
                    gen.close()
                    return
                except Exception as e:
                    # 200 is already on the wire: surface the failure as a
                    # terminal in-band event instead of a silent cutoff
                    server.stats["errors"] += 1
                    try:
                        self._chunk({"error": str(e)})
                    except OSError:
                        return
                self.wfile.write(b"0\r\n\r\n")

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b"{}"
                if self.path != "/generate":
                    self._send(404, {"error": "unknown path %s" % self.path})
                    return
                try:
                    payload = json.loads(body or b"{}")
                except ValueError as e:
                    server.stats["errors"] += 1
                    self._send(400, {"error": "malformed JSON: %s" % e})
                    return
                if isinstance(payload, dict) and payload.get("stream"):
                    self._stream(payload)
                    return
                try:
                    self._send(200, _jsonable(server._generate(payload)))
                except ValueError as e:  # bad request (incl. bucket overflow)
                    server.stats["errors"] += 1
                    self._send(400, {"error": str(e)})
                # TimeoutError subclasses OSError, not RuntimeError: listed
                # explicitly so a blocking-request timeout gets the same 503
                # the streaming path maps it to
                except (RuntimeError, TimeoutError) as e:
                    server.stats["errors"] += 1
                    self._send(503, {"error": str(e)})
                except Exception as e:
                    server.stats["errors"] += 1
                    self._send(500, {"error": str(e)})

        return Handler

    # ---------------- lifecycle ----------------

    def start(self):
        self._httpd = _HTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        logger.info("generation server on http://%s:%d (slots=%d)",
                    self.host, self.port, self.batcher.slots)
        return self

    def stop(self, stop_batcher=True):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if stop_batcher:
            self.batcher.stop()

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.stop()


def serve_tensor_parallel(batcher, **server_kwargs):
    """This rank's part of /generate over a tensor group's ContinuousBatcher
    (serving/continuous.py): the lead rank starts a GenerationServer over
    it and returns it, listening; every other rank follows the lead's
    plans until the lead's batcher stops, then returns None."""
    if batcher.is_lead:
        return GenerationServer(batcher, **server_kwargs).start()
    batcher.follow()
    return None


def serve(task_or_model_path, host="127.0.0.1", port=8080, max_batch_size=32,
          max_delay_ms=5.0, blocking=True, request_timeout_s=600.0,
          **pipeline_kwargs):
    """Build a pipeline() and serve it over HTTP.

    `task_or_model_path` follows pipeline() semantics: a model dir infers
    the task from its train_config.json, and task and registered model
    names resolve through the model registry (utils/zoo_registry.py). The
    pipeline is built, and on a card its
    kernels too, before the server starts.
    """
    from easynlp_tpu_torch.pipelines import pipeline
    from easynlp_tpu_torch.serving.continuous import build_kernels
    pipe = pipeline(task_or_model_path, **pipeline_kwargs)
    build_kernels(pipe.device)
    server = PredictionServer(
        pipe, host=host, port=port, max_batch_size=max_batch_size,
        max_delay_ms=max_delay_ms, request_timeout_s=request_timeout_s,
        info={"model": str(task_or_model_path)})
    if blocking:
        server.serve_forever()
    else:
        server.start()
    return server
