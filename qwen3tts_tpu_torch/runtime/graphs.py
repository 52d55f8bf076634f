"""Captured decode chunks: one CUDA graph per chunk program.

The port's counterpart of the JAX engine's ``jax.jit(_chunk_impl)`` and
``_build_chunk_vocode`` (``qwen3tts_tpu/runtime/engine.py``): a chunk of
frame steps, and optionally the streaming codec over its frames, captured
once into a ``torch.cuda.CUDAGraph`` and replayed for every later chunk
with the same key.  A key is (chunk size, trailing-text length, the
policies' ``StaticPolicy``, the vocoder or none, pcm16) within one KV cache:
a graph reads and writes fixed addresses, so each cache (a ``_Slot``) has
its own graphs and its own static buffers:

- the decode state's tensors (``engine.STATE_TENSORS``), which the steps
  update in place; a request's state is copied in at its first chunk on the
  slot, and its dict then points at the slot's tensors;
- the inputs: the knob tensor, the trailing text per length, the tts_pad
  embedding and the trailing-text length, copied in when the caller passes
  another tensor than the one copied last;
- the outputs per graph: ``frames [1, chunk, 16]``, ``lens``, ``done`` and,
  with the codec, the audio; the next replay of that graph overwrites them;
- the codec's stream state per vocoder: ``decode_stream`` returns a new
  state, which the graph copies back into the static one.

Every graph shares one memory pool and replays on the caller's stream; the
kernels' workspaces are one set per shape, ordered on that stream, so the
graphs never run at once.  Before a capture one eager step runs on copies of
the state, so that the kernels allocate their workspaces (they refuse to
during capture) without touching the request.  A capture that fails raises.

Sampling draws from a generator the graphs are registered with; each replay
takes the request's generator's seed and offset and hands the advanced
offset back, so a replay draws what the same steps would draw eagerly.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from .engine import STATE_TENSORS


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _copy_tree(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        d.copy_(s)


class _Graph(NamedTuple):
    """One captured chunk and its output buffers."""

    graph: torch.cuda.CUDAGraph
    frames: torch.Tensor
    lens: torch.Tensor
    done: torch.Tensor
    audio: Optional[torch.Tensor]


class _Slot:
    """One KV cache's static buffers and graphs."""

    def __init__(self, kv: Dict[str, torch.Tensor]):
        self.kv = kv
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self.inputs: Dict = {}  # name -> static tensor
        self.sources: Dict = {}  # name -> the caller's tensor copied in last
        self.voc: Dict[int, tuple] = {}  # id(vocoder) -> (vocoder, static stream state)
        self.graphs: Dict[tuple, _Graph] = {}


class ChunkGraphs:
    """The captured chunks of one Engine on the card."""

    def __init__(self, engine):
        self.engine = engine
        dev = engine.device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        self.generator = torch.Generator(device=dev)
        self._default_gen = torch.cuda.default_generators[
            dev.index if dev.index is not None else torch.cuda.current_device()]
        self._slots: Dict[int, _Slot] = {}  # id(kv) -> slot (which holds kv)
        self.captures = 0
        self.replays = 0

    def has_graphs(self, kv) -> bool:
        slot = self._slots.get(id(kv))
        return slot is not None and slot.kv is kv and bool(slot.graphs)

    def _slot(self, kv) -> _Slot:
        slot = self._slots.get(id(kv))
        if slot is None or slot.kv is not kv:
            slot = self._slots[id(kv)] = _Slot(kv)
        return slot

    def _input(self, slot: _Slot, name, src: torch.Tensor) -> torch.Tensor:
        """The slot's static copy of ``src``, refreshed when ``src`` is
        another tensor than the one copied in last."""
        buf = slot.inputs.get(name)
        if buf is None:
            buf = slot.inputs[name] = torch.empty_like(src)
        if slot.sources.get(name) is not src:
            buf.copy_(src)
            slot.sources[name] = src
        return buf

    def _bind(self, slot: _Slot, state: Dict, tth, tth_len, tpe):
        """Point the state at the slot's tensors (copying the request's
        values in at its first chunk here) and the inputs at the slot's."""
        if slot.state is None:
            slot.state = {k: torch.empty_like(state[k]) for k in STATE_TENSORS}
        for k in STATE_TENSORS:
            if state[k] is not slot.state[k]:
                slot.state[k].copy_(state[k])
                state[k] = slot.state[k]
        state["owned"] = True
        tth_s = self._input(slot, ("tth", tth.shape[1]), tth)
        tpe_s = self._input(slot, "tpe", tpe)
        n = slot.inputs.get("tth_len")
        if n is None:
            n = slot.inputs["tth_len"] = torch.empty((self.engine.batch,), dtype=torch.int64,
                                                     device=self.engine.device)
        if isinstance(tth_len, torch.Tensor):
            n.copy_(tth_len)
        else:
            n.fill_(int(tth_len))
        return tth_s, n, tpe_s

    def _bind_voc(self, slot: _Slot, vocoder, voc_state: Dict) -> Dict:
        entry = slot.voc.get(id(vocoder))
        if entry is None or entry[0] is not vocoder:
            entry = slot.voc[id(vocoder)] = (vocoder, vocoder.stream_state())
        static = entry[1]
        if voc_state is not static:
            _copy_tree(static, voc_state)
        return static

    def run(self, state: Dict, tth, tth_len, tpe, chunk: int, vocoder=None,
            voc_state: Optional[Dict] = None, pcm16: bool = False):
        """Replay (capturing first when needed) the chunk for this key.
        Returns (frames, lens, done) and, with a vocoder, also (audio,
        voc_state): the graph's buffers."""
        slot = self._slot(state["kv"])
        tth_s, tth_len_s, tpe_s = self._bind(slot, state, tth, tth_len, tpe)
        voc_s = self._bind_voc(slot, vocoder, voc_state) if vocoder is not None else None
        key = (chunk, tth.shape[1], state["policy"].static, state["pred_policy"].static,
               id(vocoder) if vocoder is not None else None, pcm16)
        g = slot.graphs.get(key)
        if g is None:
            g = slot.graphs[key] = self._capture(slot, state, tth_s, tth_len_s, tpe_s,
                                                 chunk, vocoder, voc_s, pcm16)
        src = state["generator"] if state["generator"] is not None else self._default_gen
        self.generator.set_state(src.get_state())
        g.graph.replay()
        src.set_state(self.generator.get_state())
        self.replays += 1
        if vocoder is None:
            return g.frames, g.lens, g.done
        return g.frames, g.lens, g.done, g.audio, voc_s

    def _capture(self, slot: _Slot, state: Dict, tth, tth_len, tpe, chunk: int, vocoder,
                 voc: Optional[Dict], pcm16: bool) -> _Graph:
        eng = self.engine
        B, dev = eng.batch, eng.device
        frames = torch.zeros((B, chunk, 16), dtype=torch.int64, device=dev)
        lens = torch.zeros((B,), dtype=torch.int64, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        audio = None
        if vocoder is not None:
            audio = torch.zeros((chunk * vocoder.spf,),
                                dtype=torch.int16 if pcm16 else torch.float32, device=dev)
        # one eager step (and codec call) on copies: the kernels allocate
        # their workspaces here; the request's state, stream and generator
        # stay as they were (the step's cache row at ``pos`` is rewritten by
        # the next real step before anything reads it)
        copy = {**state, **{k: slot.state[k].clone() for k in STATE_TENSORS},
                "generator": self.generator}
        eng._one_step(copy, tth, tth_len, tpe)
        if vocoder is not None:
            eng._vocode(vocoder, _clone_tree(voc), frames, pcm16)
        static = {**state, "generator": self.generator}

        def body():
            lens.zero_()
            eng._run_steps(static, tth, tth_len, tpe, frames, lens, chunk)
            done.copy_(static["done"])
            if vocoder is not None:
                a, new = eng._vocode(vocoder, voc, frames, pcm16)
                audio.copy_(a)
                _copy_tree(voc, new)

        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            body()
        self.captures += 1
        return _Graph(graph, frames, lens, done, audio)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()
