"""Async streaming front end over the continuous-batching engine.

PyTorch-port counterpart of ``repro.serve.server``, with the same names
and behaviour.  It turns the engine from a batch replayer
(``generate_all`` over a request list) into a live service:

* **Per-request token streams.**  ``await server.submit(...)`` returns a
  :class:`TokenStream`, an async iterator over the request's generated
  token ids as the engine emits them.  Each stream buffers through a
  bounded ``asyncio.Queue``: a slow consumer blocks its own pump coroutine
  at the bound, never the engine's step loop, so one stalled client cannot
  slow the other slots.
* **Admission under a running loop.**  Submissions land in a pending list
  at any time; the serve loop hands them to the engine's scheduler at the
  next iteration boundary.  The engine stays single-threaded: the loop
  alternates control operations (submit, cancel; on the event loop) with
  one engine step (on a worker thread, ``run_in_executor``), never both at
  once.
* **Cancellation and disconnect.**  ``stream.cancel()`` (or ``aclose``)
  goes through :meth:`ContinuousBatchingEngine.cancel`: at the next
  iteration boundary the slot is freed mid-decode, mid-chunked-prefill
  (the carry is dropped) or between spec windows (the committed cursor is
  what the overshoot rewind already left; the dead rows are overwritten by
  the next admission).  The request ends ``CANCELLED`` with its partial
  output kept.  With the prefix cache on, a cancelled request admitted
  onto a cached leaf's slot releases only its writer hold, so the slot is
  neither leaked nor freed twice (``Scheduler._free_slot``); with the
  tiered pool on, a cancelled victim that was swapped out while queued
  drops its pinned cold block.

Device work: an engine step (graph replays, the metered fetches and their
synchronization, the cold tier's block copies) is a blocking call, so the
loop runs it on one dedicated ``serve-step`` thread and awaits it; the
engine makes its card the current device of that thread for the step.
The event loop itself does no device work: pumps read the requests' host
token lists, and no graph is captured while serving (the engine captures
its steps when it is built).  All engine and scheduler state is changed
either inside ``step()`` (the worker thread) or between steps (the event
loop); the await is the fence between the two, so no lock is needed.
Timestamps come from the engine's monotonic clock
(:meth:`ContinuousBatchingEngine.now`).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
from typing import Any

from repro_torch.serve.engine import ContinuousBatchingEngine, RequestFailedError
from repro_torch.serve.scheduler import Request

_DONE = object()                      # stream sentinel: normal end
_TIMED_OUT = object()                 # stream sentinel: deadline exceeded


class RequestTimedOut(RuntimeError):
    """Raised by a stream whose request blew its ``deadline_s`` budget
    (terminal TIMEOUT — partial output was delivered, the tail never
    comes)."""

    def __init__(self, request: Request):
        self.request = request
        super().__init__(
            f"request {request.rid} timed out after its "
            f"{request.deadline_s}s deadline")


class _Failed:
    """Stream sentinel: the request died with ``error`` set."""

    def __init__(self, error: str):
        self.error = error


class TokenStream:
    """Async iterator over one request's generated tokens.

    Tokens flow ``engine step -> request.output -> pump coroutine ->
    bounded queue -> consumer``.  The pump blocks at the queue bound
    (backpressure); the engine's own record (``request.output``) is
    bounded by the request's token budget, so a stalled consumer costs
    one budget's worth of host ints, never device memory.
    """

    def __init__(self, server: "AsyncServer", request: Request,
                 maxsize: int):
        self._server = server
        self.request = request
        self._queue: asyncio.Queue = asyncio.Queue(maxsize)
        self._pumped = 0              # tokens moved into the queue
        self._ended = False           # pump wrote (or forced) the sentinel
        self._exhausted = False       # consumer saw the sentinel
        self._task: asyncio.Task | None = None   # the pump

    # -- consumer side -----------------------------------------------------
    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        if self._exhausted:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is _DONE:
            self._exhausted = True
            raise StopAsyncIteration
        if item is _TIMED_OUT:
            self._exhausted = True
            raise RequestTimedOut(self.request)
        if isinstance(item, _Failed):
            self._exhausted = True
            raise RequestFailedError([self.request])
        return item

    def cancel(self) -> None:
        """Disconnect: free the slot at the next engine iteration and end
        the stream immediately (undelivered tokens are dropped — the
        consumer left).  Idempotent."""
        if self._ended:
            return
        self._server._cancel_request(self.request)
        if self._task is not None and not self._task.done():
            self._task.cancel()       # pump may be parked on a full queue
        self._force_end()

    async def aclose(self) -> None:
        self.cancel()

    @property
    def cancelled(self) -> bool:
        return self.request.cancelled

    @property
    def error(self) -> "str | None":
        return self.request.error

    @property
    def timed_out(self) -> bool:
        return self.request.timed_out

    # -- producer side -----------------------------------------------------
    def _force_end(self, error: "str | None" = None, *,
                   timeout: bool = False) -> None:
        """Terminal sentinel that cannot block: on an abnormal end
        (cancel / server stop / deadline) a full queue drops its oldest
        entry to make room — the stream is dead either way and the
        consumer must wake."""
        if self._ended:
            return
        self._ended = True
        if timeout:
            item = _TIMED_OUT
        else:
            item = _Failed(error) if error is not None else _DONE
        try:
            self._queue.put_nowait(item)
        except asyncio.QueueFull:
            self._queue.get_nowait()
            self._queue.put_nowait(item)


class AsyncServer:
    """Serve loop: engine steps in a worker thread, control ops between.

    Usage::

        server = AsyncServer(engine)
        async with server:
            stream = await server.submit([1, 2, 3], max_new_tokens=16)
            async for tok in stream:
                ...

    ``stream_buffer`` bounds each stream's token queue (the backpressure
    bound).  ``stop()`` cancels whatever is still live and joins the loop;
    it is also what ``async with`` runs on exit.
    """

    def __init__(self, engine: ContinuousBatchingEngine, *,
                 stream_buffer: int = 16):
        if stream_buffer < 1:
            raise ValueError("stream_buffer must be >= 1")
        self.engine = engine
        self.stream_buffer = stream_buffer
        self.streams: dict[int, TokenStream] = {}     # rid -> stream
        self._pending: list[tuple[dict, asyncio.Future]] = []
        self._wake: asyncio.Event | None = None
        self._tick: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._stopping = False
        # one dedicated worker: engine steps must serialize, and the
        # default executor would let unrelated work delay them
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-step")

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("server already started")
        self._wake = asyncio.Event()
        self._tick = asyncio.Event()
        self._stopping = False
        self._task = asyncio.create_task(self._run(), name="serve-loop")

    async def stop(self) -> None:
        """Cancel live requests, stop the loop, join the pumps.  Clean by
        construction: the loop exits only once the scheduler is empty, so
        no slot or carry outlives the server."""
        if self._task is None:
            return
        self._stopping = True
        for stream in list(self.streams.values()):
            if not stream.request.done:
                stream.cancel()
        for _, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        self._wake.set()
        try:
            await self._task
        finally:
            self._task = None
            for stream in list(self.streams.values()):
                if stream._task is not None and not stream._task.done():
                    stream._task.cancel()
            await asyncio.gather(*(s._task for s in self.streams.values()
                                   if s._task is not None),
                                 return_exceptions=True)
            self._executor.shutdown(wait=True)

    async def __aenter__(self) -> "AsyncServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- request intake ----------------------------------------------------
    async def submit(self, prompt, max_new_tokens: int,
                     eos_id: "int | None" = None,
                     **kwargs: Any) -> TokenStream:
        """Queue a request with the running loop and return its stream.

        Resolves once the engine's scheduler has the request (at the next
        iteration boundary), so the returned stream's ``request`` carries
        the real rid/arrival timestamp.  Invalid requests (oversized
        prompt, zero budget) raise the engine's ``ValueError`` here."""
        if self._task is None:
            raise RuntimeError("server not started")
        if self._task.done():
            # the serve loop died (e.g. step-retry exhaustion): a pending
            # submission would never be admitted — fail it loudly now
            exc = (self._task.exception()
                   if not self._task.cancelled() else None)
            raise RuntimeError(
                "serve loop has terminated; the engine is no longer "
                "admitting requests") from exc
        if self._stopping:
            raise RuntimeError("server is stopping")
        fut = asyncio.get_running_loop().create_future()
        self._pending.append(
            ({"prompt": prompt, "max_new_tokens": max_new_tokens,
              "eos_id": eos_id, **kwargs}, fut))
        self._wake.set()
        req = await fut
        stream = TokenStream(self, req, self.stream_buffer)
        self.streams[req.rid] = stream
        stream._task = asyncio.create_task(
            self._pump(stream), name=f"pump-{req.rid}")
        return stream

    def _cancel_request(self, req: Request) -> None:
        """Engine-side half of a disconnect (stream side is immediate)."""
        self.engine.cancel(req)
        if self._wake is not None:
            self._wake.set()

    # -- serve loop --------------------------------------------------------
    def _admit_pending(self) -> None:
        """Hand buffered submissions to the engine scheduler.  Runs on the
        event loop strictly between engine steps."""
        pending, self._pending = self._pending, []
        for kwargs, fut in pending:
            if fut.done():            # cancelled while waiting
                continue
            try:
                fut.set_result(self.engine.submit(**kwargs))
            except Exception as e:                    # noqa: BLE001
                fut.set_exception(e)

    def _publish(self) -> None:
        """Wake every pump waiting for this iteration's tokens."""
        tick, self._tick = self._tick, asyncio.Event()
        tick.set()

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                self._admit_pending()
                eng = self.engine
                if eng.scheduler.has_work() or eng._cancels:
                    await loop.run_in_executor(self._executor, eng.step)
                    self._publish()
                    continue
                self._publish()       # flush terminal states to the pumps
                if self._stopping:
                    break
                self._wake.clear()
                if self._pending or eng._cancels:
                    continue          # raced a submit between drain and clear
                await self._wake.wait()
        except Exception as e:        # noqa: BLE001 — e.g. an exhausted retry budget
            msg = f"serve loop failed: {type(e).__name__}: {e}"
            for stream in list(self.streams.values()):
                stream._force_end(msg)
            for _, fut in self._pending:
                if not fut.done():
                    fut.set_exception(RuntimeError(msg))
            self._pending.clear()
            raise

    async def _pump(self, stream: TokenStream) -> None:
        """Move one request's tokens into its bounded queue.  A full queue
        blocks *here* — the serve loop and the other streams keep going."""
        req = stream.request
        try:
            while True:
                tick = self._tick    # capture before the check: no lost wakeup
                out = req.output
                while stream._pumped < len(out):
                    await stream._queue.put(out[stream._pumped])
                    stream._pumped += 1
                if req.done:
                    break
                await tick.wait()
            if req.error is not None:
                stream._force_end(req.error)
            elif req.timed_out:
                stream._force_end(timeout=True)
            elif req.cancelled:
                stream._force_end()
            else:
                # normal completion: the sentinel queues behind every
                # delivered token (blocking until the consumer drains)
                await stream._queue.put(_DONE)
                stream._ended = True
        except asyncio.CancelledError:
            stream._force_end()       # disconnect/stop killed the pump
        except Exception as e:        # noqa: BLE001 — never hang the consumer
            stream._force_end(f"{type(e).__name__}: {e}")
            raise


async def collect(stream: TokenStream) -> list[int]:
    """Drain a stream to a list — the closed-loop convenience."""
    return [tok async for tok in stream]
