"""Captured steps: a step of fixed-shape tensors as one replayable program.

The JAX package jits its steps: the tracker step (`tpupose/tracking/
tracker.py:797`), so that a frame is one XLA program, and every training
step, the train step (`tpupose/models/train.py:116-133`, jitted by its
callers) and distill-QAT's (`tpupose/models/quantize.py:455-459`). Eager
PyTorch issues every op of a step from the host instead (about 1,800
kernels a tracker frame on an H100, about 5,000 a W48 training step), and
the host's issue, not the card, sets the step's time. The port's
counterpart of `jax.jit` is a CUDA graph captured once per key and
replayed at every call. Two kinds of step are captured:

* The tracker step, a pure function fn(cams, state, dets, mask, frame_id)
  -> (state, out): `CapturedStep`, kept per (tag, device, shapes, dtypes)
  for the process by `captured_step` (`steps()` lists them).
  - `Layout` lays the fields of a NamedTuple of tensors out as views of one
    flat byte buffer, so that copying a whole state or FrameOutput is one
    copy, not one a field.
  - It holds static buffers for the cams, the state, the frame's inputs
    (the frame id a 0-d or (S,) int32 tensor on the device, filled outside
    the program, never a constant inside it) and the outputs. It runs fn a
    few times eagerly on a side stream, on throw-away inputs (the K3
    library's build and load, each K3 variant's first launch, the
    smoothing weights' one copy, cuBLAS handles), captures it with
    `torch.cuda.graph` into one memory pool a device, shared by every
    tracker graph on it, and ends the program with copies of the new state
    into the static state, so that the program advances itself.
  - The JAX contract holds: what a step returns belongs to the caller and
    no later call overwrites it (the state and the outputs are handed out
    as copies). The state is copied in only when the caller passes
    something other than the state the step last returned; the cams when
    they are not the tensors last copied (or one of them was written in
    place since). Graphs on one device share a memory pool, so they must
    be replayed on one stream, one after the other, as every caller here
    does.
* A training step of loss_fn(*batch) -> loss and an optimizer, which
  zeroes the gradients, runs the forward and the backward and steps the
  optimizer, all in place: `CapturedUpdate` (`models.train.make_train_step`,
  `quantize.distill_qat`, and `models.train.ShardedTrainStep`, which adds
  the parameters' all-gather to its forward and the gradients' all-reduce
  after the backward through the `_reduce` hook, NCCL collectives inside
  the graph).
  - Static input buffers take each call's batch (a device-to-device copy);
    the loss is handed out as a copy.
  - The step is not pure, so its warm-ups are real steps: the first
    WARMUP calls of a key run the step eagerly on the side stream, on the
    caller's batches in order (the optimizer's lazy state, cuDNN's
    algorithm choice, the one-time allocations). The next call captures,
    and then replays once, since a capture runs nothing.
  - Every trained tensor gets a zero `.grad` before the first step, and
    keeps that tensor: the step zeroes it in place
    (`zero_grad(set_to_none=False)`) and the backward accumulates into it,
    so every graph of the step reads and writes the same gradients, and
    they stay in `.grad` after any call.
  - The key is the device, the batch's shapes and dtypes, and the backend
    flags that change what a capture records (`backend_flags`). A changed
    optimizer setting (`lr`, betas, ..., a replaced state after
    `load_state_dict`) drops the step's graphs, and the next calls warm up
    and capture anew: a graph never replays stale constants.
  - Each CapturedUpdate captures into a memory pool of its own (a W48
    step's activations are several GiB), which `release()` hands back.
  - On CUDA the optimizer must be capturable (`require_capturable`):
    capturable Adam keeps its step count and bias corrections on the card.
  - Inside `disable_capture()` a CapturedUpdate runs its step eagerly on
    the caller's tensors, as `jax.disable_jit` runs a jitted function op
    by op: the reference a graph is held against.

On the CPU the same buffers are written by running the step eagerly at
each replay, as a kernel's plain version stands in for it there.

Kernel launch counters (`ops.lap.launches`, which the tracker step runs)
count executions: a capture's increments are taken back (nothing ran) and
recorded as the launches the graph holds, which every replay adds again.
The warm-up's launches ran, and stay counted. A training step counts
`parallel.mesh`'s collectives the same way (they run no counted kernel).
A failed capture or replay raises; a CUDA step never falls back to eager
execution.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import time

import torch

#: Byte alignment of each field in a flat buffer: a field starts where an
#: allocation of its own would, as far as any kernel's vectorization can
#: tell, so that a step reads its inputs as the eager step does.
ALIGN = 256
#: Eager runs before a capture.
WARMUP = 2

#: (tag, device, shapes and dtypes) -> CapturedStep, for the process.
_STEPS: dict = {}
#: device -> the memory pool every graph on it captures into.
_POOLS: dict = {}
#: device -> the side stream of warm-ups and captures.
_STREAMS: dict = {}


def _counters():
    """The launch counters a tracker capture may increment, as (module,
    name)."""
    from tpupose_torch.ops import lap

    return ((lap, "launches"),)


def _collective_counters():
    """The collective counters a training capture may increment
    (`parallel.mesh`'s, by kind), as (module, name)."""
    from tpupose_torch.parallel import mesh

    return tuple((mesh, name) for name in mesh.COUNTERS)


def _read_counts(counters):
    return [getattr(m, n) for m, n in counters]


def _add_counts(counters, counts, sign=1):
    for (m, n), c in zip(counters, counts):
        setattr(m, n, getattr(m, n) + sign * c)


class Layout:
    """Tensors of fixed shapes and dtypes as views of one flat uint8
    buffer, each field at an offset that is a multiple of ALIGN.

    `empty(lead)` makes a (*lead, nbytes) buffer, and `views(flat)` gives
    the fields of each row with the leading dimensions in front."""

    def __init__(self, examples):
        self.specs = [(tuple(t.shape), t.dtype) for t in examples]
        self.offsets, n = [], 0
        for shape, dtype in self.specs:
            self.offsets.append(n)
            size = math.prod(shape) * dtype.itemsize
            n += -(-size // ALIGN) * ALIGN
        self.nbytes = n

    def empty(self, lead=(), device=None):
        return torch.empty(tuple(lead) + (self.nbytes,), dtype=torch.uint8, device=device)

    def views(self, flat):
        lead = tuple(flat.shape[:-1])
        return [flat.narrow(-1, off, math.prod(shape) * dtype.itemsize)
                .view(dtype).view(lead + shape)
                for off, (shape, dtype) in zip(self.offsets, self.specs)]


class _Eager:
    """The CPU's program: the body runs at every replay."""

    def node_counts(self):
        return None

    def warmup(self, fn, n):
        return fn()

    def capture(self, body):
        self.body = body

    def replay(self):
        self.body()


def _side_stream(device):
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def _pool(device):
    pool = _POOLS.get(device)
    if pool is None:
        with torch.cuda.device(device):
            pool = _POOLS[device] = torch.cuda.graph_pool_handle()
    return pool


class _Graph:
    """A CUDA graph on `device`: warm-up and capture on the device's side
    stream, into `pool` (by default the device's shared pool); replay on
    the current stream."""

    def __init__(self, device, pool=None):
        self.device = device
        self.pool = pool
        self.graph = None

    def warmup(self, fn, n):
        s = _side_stream(self.device)
        with torch.cuda.device(self.device):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                for _ in range(n):
                    out = fn()
            torch.cuda.current_stream().wait_stream(s)
        return out

    def capture(self, body):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.device(self.device), torch.cuda.graph(
                g, pool=self.pool if self.pool is not None else _pool(self.device),
                stream=_side_stream(self.device),
                capture_error_mode="thread_local"):
            body()
        g.instantiate()
        self.graph = g

    def node_counts(self):
        return graph_node_counts(self.graph.raw_cuda_graph())

    def replay(self):
        self.graph.replay()


#: CUgraphNodeType values (cuda.h) -> names, for `graph_node_counts`.
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "wait_event", 7: "event_record", 10: "mem_alloc",
               11: "mem_free"}


def graph_node_counts(raw_graph) -> dict:
    """Nodes of a cudaGraph_t by type ({"kernel": n, ...}), through
    `libcuda.so.1`'s `cuGraphGetNodes` and `cuGraphNodeGetType`."""
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    nodes = (ctypes.c_void_p * n.value)()
    rc = cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    counts: dict = {}
    kind = ctypes.c_int(0)
    for node in nodes[:n.value]:
        rc = cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if rc != 0:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {rc}")
        name = _NODE_TYPES.get(kind.value, f"type_{kind.value}")
        counts[name] = counts.get(name, 0) + 1
    return counts


def _version(t):
    """The in-place write counter of a tensor (None for an inference
    tensor, which keeps none)."""
    return None if t.is_inference() else t._version


class CapturedStep:
    """fn(cams, state, dets, mask, frame_id) -> (state, out) over static
    buffers, captured as one program on CUDA (see the module docstring).

    The example inputs fix the shapes and dtypes; the frame id is kept as
    int32 of its shape (0-d for one stream, (S,) for S). `step` runs one
    frame and returns copies; `clip` runs a (F, ...) clip of frames,
    copying each frame's outputs into one preallocated (F, ...) buffer."""

    def __init__(self, fn, cams, state, dets, mask, frame_id, program=None):
        self.fn = fn
        self.device = device = state[0].device
        if program is None:
            program = _Graph(device) if device.type == "cuda" else _Eager()
        self._program = program
        frame_id = torch.as_tensor(frame_id)
        self.replays = 0
        with torch.inference_mode():
            self._cams_layout = Layout(cams)
            self._cams_flat = self._cams_layout.empty(device=device)
            self.cams = type(cams)(*self._cams_layout.views(self._cams_flat))
            self._state_type = type(state)
            self._state_layout = Layout(state)
            self._state_flat = self._state_layout.empty(device=device)
            self._next_flat = self._state_layout.empty(device=device)
            self.state = type(state)(*self._state_layout.views(self._state_flat))
            self._next = self._state_layout.views(self._next_flat)
            self._in_layout = Layout([dets, mask, frame_id.to(torch.int32)])
            self._in_flat = self._in_layout.empty(device=device)
            self.dets, self.mask, self.frame_id = self._in_layout.views(self._in_flat)
            self._loaded_state = None
            self._loaded_cams = None
            self._load(cams, state, dets, mask, frame_id)

            counts = _read_counts(_counters())
            t0 = time.perf_counter()
            _, out = program.warmup(self._call, WARMUP)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.warmup_s = time.perf_counter() - t0
            self.warmup_launches = [a - b for a, b in zip(_read_counts(_counters()), counts)]
            self._out_type = type(out)
            self._out_layout = Layout(out)
            self._out_flat = self._out_layout.empty(device=device)
            self._out = self._out_layout.views(self._out_flat)
            del out

            reserved = 0
            if device.type == "cuda":
                torch.cuda.empty_cache()  # as the capture does: its pool alone grows
                reserved = torch.cuda.memory_reserved(device)
            counts = _read_counts(_counters())
            t0 = time.perf_counter()
            program.capture(self._body)
            self.capture_s = time.perf_counter() - t0
            after = _read_counts(_counters())
            # a capture launches nothing: its increments are what each replay runs
            self.held_launches = [a - b for a, b in zip(after, counts)]
            _add_counts(_counters(), self.held_launches, -1)
            self.pool_bytes = ((torch.cuda.memory_reserved(device) - reserved)
                               if device.type == "cuda" else 0)

    def _call(self):
        return self.fn(self.cams, self.state, self.dets, self.mask, self.frame_id)

    def _body(self):
        """The captured program: one step on the static inputs, its outputs
        and new state into static buffers, then the new state over the
        static state (through a second buffer, so that no new field can
        alias an input field that is already overwritten)."""
        state, out = self._call()
        for dst, src in zip(self._out, out):
            dst.copy_(src)
        for dst, src in zip(self._next, state):
            dst.copy_(src)
        self._state_flat.copy_(self._next_flat)

    def _replay(self):
        self._program.replay()
        self.replays += 1
        _add_counts(_counters(), self.held_launches)

    def _load_context(self, cams, state):
        """Copy the cams and the state in where they changed."""
        cams_now = tuple((t, _version(t)) for t in cams)
        if self._loaded_cams is None or any(
                a is not b or va != vb
                for (a, va), (b, vb) in zip(cams_now, self._loaded_cams)):
            for dst, src in zip(self.cams, cams):
                dst.copy_(src)
            self._loaded_cams = cams_now
        if state is not self._loaded_state:
            for dst, src in zip(self.state, state):
                dst.copy_(src)
            self._loaded_state = state

    def _load(self, cams, state, dets, mask, frame_id):
        self._load_context(cams, state)
        self.dets.copy_(torch.as_tensor(dets))
        self.mask.copy_(torch.as_tensor(mask))
        frame_id = torch.as_tensor(frame_id)
        if frame_id.device.type == "cpu" and frame_id.numel() == 1:
            # a fill, not a host-to-device copy that would wait for the stream
            self.frame_id.fill_(int(frame_id))
        else:
            self.frame_id.copy_(frame_id)

    def _hand_out_state(self):
        state = self._state_type(*self._state_layout.views(self._state_flat.clone()))
        self._loaded_state = state
        return state

    def step(self, cams, state, dets, mask, frame_id):
        """One frame: (new state, outputs), both the caller's."""
        with torch.inference_mode():
            self._load(cams, state, dets, mask, frame_id)
            self._replay()
            out = self._out_type(*self._out_layout.views(self._out_flat.clone()))
            return self._hand_out_state(), out

    def clip(self, cams, state, dets, mask, frame_ids):
        """F frames in order (dets, mask, frame_ids with a leading F): the
        final state and the outputs stacked over F. The clip's inputs are
        packed once, so that a frame costs one copy in, one replay and one
        copy out."""
        with torch.inference_mode():
            frames = dets.shape[0]
            packed = self._in_layout.empty((frames,), device=self.device)
            for dst, src in zip(self._in_layout.views(packed), (dets, mask, frame_ids)):
                dst.copy_(torch.as_tensor(src))
            outs = self._out_layout.empty((frames,), device=self.device)
            self._load_context(cams, state)
            for f in range(frames):
                self._in_flat.copy_(packed[f])
                self._replay()
                outs[f].copy_(self._out_flat)
            return self._hand_out_state(), self._out_type(
                *(x.contiguous() for x in self._out_layout.views(outs)))

    def stats(self) -> dict:
        """Capture and replay figures, for the record."""
        names = [f"{m.__name__.rsplit('.', 1)[-1]}.{n}" for m, n in _counters()]
        return {"device": str(self.device), "warmup_s": self.warmup_s,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "graph_nodes": self._program.node_counts(),
                "held_launches": dict(zip(names, self.held_launches)),
                "warmup_launches": dict(zip(names, self.warmup_launches)),
                "replays": self.replays}


def _signature(*trees):
    return tuple((tuple(t.shape), t.dtype) for tree in trees for t in tree)


def captured_step(tag, fn, cams, state, dets, mask, frame_id) -> CapturedStep:
    """The process's CapturedStep of fn for `tag` (hashable: a function's
    name and its static configuration) at these inputs' device, shapes and
    dtypes, captured on first use with these inputs as the examples."""
    dets, mask = torch.as_tensor(dets), torch.as_tensor(mask)
    frame_id = torch.as_tensor(frame_id)
    key = (tag, state[0].device, _signature(cams, state, (dets, mask)),
           tuple(frame_id.shape))
    step = _STEPS.get(key)
    if step is None:
        step = _STEPS[key] = CapturedStep(fn, cams, state, dets, mask, frame_id)
    return step


def steps() -> dict:
    """Every CapturedStep of the process, by key."""
    return dict(_STEPS)


# -- training steps ---------------------------------------------------------------

#: Open `disable_capture()` blocks.
_capture_disabled = 0
#: `backend_flags()`'s fields, for the record.
FLAG_NAMES = ("cudnn.allow_tf32", "cudnn.deterministic", "cudnn.benchmark",
              "cuda.matmul.allow_tf32")


@contextlib.contextmanager
def disable_capture():
    """Inside the block every `CapturedUpdate` runs its step eagerly on the
    caller's tensors, as `jax.disable_jit` runs jitted functions op by op."""
    global _capture_disabled
    _capture_disabled += 1
    try:
        yield
    finally:
        _capture_disabled -= 1


def backend_flags():
    """The backend settings that change what a capture records (the
    algorithms cuDNN and cuBLAS choose), in FLAG_NAMES' order."""
    return (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32)


def capturable(tensors) -> bool:
    """Whether an optimizer over `tensors` is to be built capturable: on
    CUDA, where its step is replayed in a graph (capturable Adam refuses
    CPU tensors)."""
    return any(t.is_cuda for t in tensors)


def require_capturable(optimizer):
    """Raise ValueError if a parameter group of `optimizer` has its
    `capturable` setting off: a CUDA graph of its step would replay the
    step count and bias corrections of the capture."""
    for i, group in enumerate(optimizer.param_groups):
        if group.get("capturable") is False:
            raise ValueError(
                f"{type(optimizer).__name__}: parameter group {i} is not capturable, and a "
                f"training step on CUDA replays a CUDA graph; build the optimizer with "
                f"capturable=True (models.train.make_optimizer does so for CUDA tensors)")


def _settings(optimizer):
    """What a capture bakes in of `optimizer`: its state dict (replaced by
    `load_state_dict`), each group's tensor list and settings."""
    return [optimizer.state] + [(g["params"], len(g["params"]),
                                 {k: v for k, v in g.items() if k != "params"})
                                for g in optimizer.param_groups]


def _same(a, b):
    """Settings equal: tensors by identity (a graph reads them in place),
    sequences item by item, anything else by type and value."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def _same_settings(now, then):
    if len(now) != len(then) or now[0] is not then[0]:
        return False
    for (pa, na, sa), (pb, nb, sb) in zip(now[1:], then[1:]):
        if pa is not pb or na != nb or sa.keys() != sb.keys() or not all(
                _same(v, sb[k]) for k, v in sa.items()):
            return False
    return True


class _UpdateKey:
    """One key of a CapturedUpdate: the static batch, the static loss, the
    program and its figures."""

    def __init__(self, inputs, program):
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in inputs]
        self.program = program
        self.loss = None
        self.warmups = self.replays = 0
        self.captured = False
        self.capture_s = None
        self.pool_bytes = 0
        self.held_collectives = None  # what the graph issues a replay, by kind


class CapturedUpdate:
    """A training step of `loss_fn(*batch) -> loss` and `optimizer`: zero
    the gradients in place, forward, backward, optimizer step; as one CUDA
    graph a key (see the module docstring).

    `__call__(*batch)` copies the batch into the key's static buffers and
    runs a warm-up, or captures and replays, or replays; it returns the
    loss, the caller's. `eager(*batch)` runs the step on the batch itself.
    `stats()` gives each key's figures; `release()` drops the graphs."""

    def __init__(self, loss_fn, optimizer):
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self._keys: dict = {}
        self._pool = None
        self._settings = _settings(optimizer)
        self._grads = []
        self._collect_grads()

    def _collect_grads(self):
        """(tensor, gradient) for every tensor of the optimizer: the `.grad`
        this step found or made for it first, a zero tensor of its shape and
        strides."""
        held = {id(p): g for p, g in self._grads}
        self._grads = []
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                g = held.get(id(p))
                if g is None:
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                self._grads.append((p, g))

    def _bind_grads(self):
        """Point every `.grad` back at this step's gradient (a caller may have
        set it to None); the graphs read and write those tensors."""
        for p, g in self._grads:
            if p.grad is not g:
                p.grad = g

    def _drop(self):
        """Forget every key, after the card has run its graphs; returns the
        keys' devices."""
        devices = {e.inputs[0].device for e in self._keys.values()}
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self._keys.clear()
        self._pool = None
        return devices

    def release(self):
        """Drop every graph and static buffer of this step and hand their
        pool's memory back to the card. The next call of a key warms up
        and captures anew."""
        if any(d.type == "cuda" for d in self._drop()):
            torch.cuda.empty_cache()

    def _check_settings(self):
        now = _settings(self.optimizer)
        if not _same_settings(now, self._settings):
            self._drop()
            self._settings = now
            self._collect_grads()

    def _program(self, device):
        if device.type != "cuda":
            return _Eager()
        if self._pool is None:
            with torch.cuda.device(device):
                self._pool = torch.cuda.graph_pool_handle()
        return _Graph(device, self._pool)

    def _body(self, *inputs):
        """One step: the gradients zeroed in place (every graph of the step
        shares them), then accumulated by the backward, then `_reduce`d."""
        self._zero_grads()
        with torch.enable_grad():
            loss = self.loss_fn(*inputs)
            loss.backward()
        loss = self._reduce(loss.detach())
        self.optimizer.step()
        return loss

    def _zero_grads(self):
        self.optimizer.zero_grad(set_to_none=False)

    def _reduce(self, loss):
        """After the backward, before the optimizer step: a subclass's
        reduction of the gradients; returns the loss the step returns."""
        return loss

    def _key(self, inputs):
        """The key of a call: the device, the batch's shapes and dtypes, the
        backend flags."""
        return (inputs[0].device, tuple((tuple(t.shape), t.dtype) for t in inputs),
                backend_flags())

    def _new_key(self, key, inputs):
        if key[0].type == "cuda":
            require_capturable(self.optimizer)
        entry = self._keys[key] = _UpdateKey(inputs, self._program(key[0]))
        return entry

    def eager(self, *inputs):
        """One step on the caller's tensors, op by op."""
        self._bind_grads()
        return self._body(*inputs)

    def __call__(self, *inputs):
        if _capture_disabled:
            return self.eager(*inputs)
        self._check_settings()
        key = self._key(inputs)
        entry = self._keys.get(key)
        if entry is None:
            entry = self._new_key(key, inputs)
        for dst, src in zip(entry.inputs, inputs):
            dst.copy_(src)
        self._bind_grads()
        if entry.warmups < WARMUP:
            loss = entry.program.warmup(lambda: self._body(*entry.inputs), 1).clone()
            entry.warmups += 1
            if entry.loss is None:
                entry.loss = torch.empty_like(loss)
            return loss
        if not entry.captured:
            self._capture(entry)
        entry.program.replay()
        entry.replays += 1
        _add_counts(_collective_counters(), entry.held_collectives)
        return entry.loss.clone()

    def _capture(self, entry):
        device = entry.inputs[0].device

        def record():
            entry.loss.copy_(self._body(*entry.inputs))

        reserved = 0
        if device.type == "cuda":
            torch.cuda.empty_cache()  # as the capture does: its pool alone grows
            reserved = torch.cuda.memory_reserved(device)
        counts = _read_counts(_collective_counters())
        t0 = time.perf_counter()
        entry.program.capture(record)
        entry.capture_s = time.perf_counter() - t0
        # a capture issues nothing: its collectives are what each replay issues
        entry.held_collectives = [a - b for a, b in zip(
            _read_counts(_collective_counters()), counts)]
        _add_counts(_collective_counters(), entry.held_collectives, -1)
        if device.type == "cuda":
            entry.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        entry.captured = True

    def stats(self) -> list:
        """Each key's figures: its batch, flags, warm-ups, capture seconds,
        pool bytes, the graph's nodes by type, the collectives it holds by
        kind, its replays."""
        names = [n for _, n in _collective_counters()]
        return [{"device": str(device), "shapes": [list(s) for s, _ in sig],
                 "dtypes": [str(d).removeprefix("torch.") for _, d in sig],
                 "flags": dict(zip(FLAG_NAMES, flags)), "warmups": e.warmups,
                 "capture_s": e.capture_s, "pool_bytes": e.pool_bytes,
                 "graph_nodes": e.program.node_counts() if e.captured else None,
                 "held_collectives": (dict(zip(names, e.held_collectives))
                                      if e.captured else None),
                 "replays": e.replays}
                for (device, sig, flags, *_), e in self._keys.items()]
