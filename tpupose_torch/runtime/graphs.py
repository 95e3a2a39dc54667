"""Captured steps: a function of fixed-shape tensors as one replayable program.

The JAX package jits its tracker step (`tpupose/tracking/tracker.py:797`),
so that a frame is one XLA program and the host issues one launch. Eager
PyTorch issues every op of the step from the host instead (about 1,800
kernels a frame on an H100), and the host's issue, not the card, sets stage
B's time.
The port's counterpart of `jax.jit` is a CUDA graph captured once and
replayed each frame:

* `Layout` lays the fields of a NamedTuple of tensors out as views of one
  flat byte buffer, so that copying a whole state or FrameOutput is one
  copy, not one a field.
* `CapturedStep` holds static buffers for fn(cams, state, dets, mask,
  frame_id) -> (state, out): the cams, the state, the frame's inputs (the
  frame id a 0-d or (S,) int32 tensor on the device, filled outside the
  program, never a constant inside it) and the outputs. It runs fn a few
  times eagerly on a side stream (the K3 library's build and load, each K3
  variant's first launch, the smoothing weights' one copy, cuBLAS
  handles), captures it with `torch.cuda.graph`, one memory pool a device
  shared by every graph on it, and ends the program with copies of the new
  state into the static state, so that the program advances itself.
  On the CPU the same buffers are written by running fn eagerly at each
  replay, as a kernel's plain version stands in for it there.
* `captured_step` keeps one CapturedStep per (tag, device, input shapes and
  dtypes) for the process: a graph is captured once per key (`steps()`
  lists them).

The JAX contract holds: what a step returns belongs to the caller and no
later call overwrites it (the state and the outputs are handed out as
copies). The state is copied in only when the caller passes something other
than the state the step last returned; the cams when they are not the
tensors last copied (or one of them was written in place since). Graphs on
one device share a memory pool, so they must be replayed on one stream, one
after the other, as every caller here does.

Kernel launch counters (`ops.lap.launches`) count executions: a capture's
increments are taken back (nothing ran) and recorded as the launches the
graph holds, which every replay adds again. The warm-up's launches ran, and
stay counted. A failed capture or replay raises; a CUDA step never falls
back to eager execution.
"""
from __future__ import annotations

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
    """The launch counters a capture may increment, as (module, name)."""
    from tpupose_torch.ops import lap

    return ((lap, "launches"),)


def _read_counts():
    return [getattr(m, n) for m, n in _counters()]


def _add_counts(counts, sign=1):
    for (m, n), c in zip(_counters(), counts):
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
    stream, into its shared pool; replay on the current stream."""

    def __init__(self, device):
        self.device = device
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
                g, pool=_pool(self.device), stream=_side_stream(self.device),
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

            counts = _read_counts()
            t0 = time.perf_counter()
            _, out = program.warmup(self._call, WARMUP)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.warmup_s = time.perf_counter() - t0
            self.warmup_launches = [a - b for a, b in zip(_read_counts(), counts)]
            self._out_type = type(out)
            self._out_layout = Layout(out)
            self._out_flat = self._out_layout.empty(device=device)
            self._out = self._out_layout.views(self._out_flat)
            del out

            reserved = 0
            if device.type == "cuda":
                torch.cuda.empty_cache()  # as the capture does: its pool alone grows
                reserved = torch.cuda.memory_reserved(device)
            counts = _read_counts()
            t0 = time.perf_counter()
            program.capture(self._body)
            self.capture_s = time.perf_counter() - t0
            after = _read_counts()
            # a capture launches nothing: its increments are what each replay runs
            self.held_launches = [a - b for a, b in zip(after, counts)]
            _add_counts(self.held_launches, -1)
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
        _add_counts(self.held_launches)

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
