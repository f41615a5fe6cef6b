"""KV-cache management for batched continuous serving, as in the JAX
package's `serve/kvcache.py`: fixed-capacity per-slot caches with
free-list admission and host-side slot recycling.

Slot lifecycle: admit -> prefill (the prefill's argmax IS the first
emitted token, so EOS/max_new are checked at submit time) -> decode ticks
-> retire. Retirement releases the cache slot AND clears the per-slot
pending-token entry; finished outputs accumulate until `drain()` hands
them to the caller.

Unlike the JAX version, decode writes its cache updates (the new K/V row
at the position or ring slot, the Mamba conv rows and state, the xLSTM
states and conv rows) into the pool in place: a tick whose slots form a
contiguous range decodes on a view of the pool, and only a scattered set
of slots is gathered and written back. Each leaf keeps the dtype
`Model.init_cache` gave it, as the JAX pool casts on write: the pool's
dtype (bf16 by default) for K/V, hymba's Mamba state and the xLSTM C, n,
h, c and conv rows, fp32 for the xLSTM stabilisers m and the Mamba-2
mixers' states (granite-4.0-h), whose conv rows take the pool's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map


@dataclasses.dataclass
class SlotState:
    request_id: Optional[str] = None
    pos: int = 0                 # absolute position of the next token
    done: bool = True
    group: Optional[str] = None  # serving-group tag (fleet plane)


class CacheManager:
    """Fixed-slot KV cache pool with free-list admission. All device state
    is one cache tree with a slot axis of size `num_slots` (leaves
    (layers, slots, ...)). `capacity` is the prompt + generation budget of
    a request; the pool's position space adds the model's meta tokens."""

    def __init__(self, model: Model, *, num_slots: int, capacity: int,
                 dtype=torch.bfloat16, device="cuda"):
        self.model = model
        self.num_slots = num_slots
        self.user_capacity = capacity            # prompt+generation budget
        self.capacity = capacity + model.cfg.meta_tokens
        self.cache = model.init_cache(num_slots, self.capacity, dtype, device)
        self.slots: List[SlotState] = [SlotState() for _ in
                                       range(num_slots)]

    # -- admission ----------------------------------------------------------
    def check_fit(self, prompt_len: int, max_new: int):
        """A request's last decode step writes cache position
        prompt_len + meta_tokens + max_new - 2 (prefill emits token #1),
        so it fits iff prompt_len + max_new - 1 <= user_capacity. Raises
        otherwise: an oversized prompt must fail admission, not overflow
        its slot."""
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1; got {max_new}")
        if prompt_len + max_new - 1 > self.user_capacity:
            raise ValueError(
                f"request does not fit its slot: prompt_len={prompt_len} "
                f"+ max_new={max_new} - 1 > capacity={self.user_capacity} "
                f"(largest admissible prompt is "
                f"{self.user_capacity - max_new + 1} tokens)")

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.done]

    def admit(self, request_id: str, *, prompt_len: Optional[int] = None,
              max_new: int = 1, group: Optional[str] = None) -> int:
        if prompt_len is not None:
            self.check_fit(prompt_len, max_new)
        free = self.free_slots()
        if not free:
            raise RuntimeError("cache pool exhausted")
        i = free[0]
        self.slots[i] = SlotState(request_id=request_id, pos=0, done=False,
                                  group=group)
        return i

    def release(self, slot: int):
        self.slots[slot] = SlotState()

    def write_prefill(self, slot: int, slot_cache, pos: int):
        """Copy a single-request prefill cache (batch dim 1) into the pool
        at `slot`."""
        self.write_prefill_many([slot], slot_cache, pos)

    def write_prefill_many(self, slots: List[int], batch_cache, pos: int):
        """Copy a batched prefill cache (batch dim >= len(slots); lanes
        past len(slots) are dropped) into the pool at `slots`, one write
        per leaf for the whole admission wave (K/V, ring, meta rows, Mamba
        conv and state, xLSTM states and conv rows, in the cache spec's
        key order, which the prefill cache keeps), each cast to its pool
        leaf's dtype. Contiguous slots are written through a slice."""
        n = len(slots)
        lo = slots[0]
        if slots == list(range(lo, lo + n)):
            sel = slice(lo, lo + n)
        else:
            sel = torch.as_tensor(slots, device=tree_leaves(self.cache)[0]
                                  .device)
        for dst, src in zip(tree_leaves(self.cache),
                            tree_leaves(batch_cache), strict=True):
            dst[:, sel] = src[:, :n].to(dst.dtype)
        for i in slots:
            self.slots[i].pos = int(pos)

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.done]

    def utilization(self) -> float:
        return len(self.active()) / self.num_slots


class ServeLoop:
    """Batched continuous serving driver: admit -> prefill -> decode ticks
    over the slot pool, retiring requests at EOS/limit. Runs on the device
    the parameters lie on. `params` None (the fleet plane, whose params
    are per group) takes the `device` given instead; `cache_dtype` is the
    pool's (bf16, as the JAX pool's)."""

    def __init__(self, model: Model, params, *, num_slots: int = 8,
                 capacity: int = 256, eos_id: Optional[int] = None,
                 max_new: int = 32, compute_dtype=torch.bfloat16,
                 cache_dtype=torch.bfloat16, device=None):
        from repro_torch.serve.serve_step import make_decode_step, \
            make_prefill_step
        self.model = model
        # Serving weights are stored once in the compute dtype: every op
        # casts its weights to the compute dtype anyway, so the values are
        # identical and no decode step re-casts the whole model.
        self.params = None if params is None else tree_map(
            lambda t: t.to(compute_dtype), params)
        self.device = (torch.device(device) if params is None
                       else tree_leaves(params)[0].device)
        self.mgr = CacheManager(model, num_slots=num_slots,
                                capacity=capacity, dtype=cache_dtype,
                                device=self.device)
        self.eos_id = eos_id
        self.max_new = max_new
        self.outputs: Dict[str, List[int]] = {}
        self._new_tokens: Dict[int, int] = {}
        self._finished: List[str] = []
        self.decode_calls = 0        # one per (tick, distinct position)
        self._prefill = make_prefill_step(model, self.mgr.capacity,
                                          compute_dtype=compute_dtype)
        self._decode = make_decode_step(model, compute_dtype=compute_dtype)

    # -- slot lifecycle ------------------------------------------------------
    def _retire(self, slot: int):
        """Release the cache slot AND the per-slot decode state, so a
        recycled slot cannot replay the dead request's last token."""
        st = self.mgr.slots[slot]
        if st.request_id is not None:
            self._finished.append(st.request_id)
        self._new_tokens.pop(slot, None)
        self.mgr.release(slot)

    def _record_first(self, request_id: str, slot: int, first: int) -> bool:
        """Record the prefill's argmax as emitted token #1 and apply the
        retirement rule to it (max_new == 1, or EOS on the prefill token).
        Returns True when the request already finished at submit time."""
        self.outputs[request_id] = [first]
        if (self.eos_id is not None and first == self.eos_id) \
                or self.max_new <= 1:
            self._retire(slot)
            return True
        self._new_tokens[slot] = first
        return False

    def _emit(self, slot: int, token: int) -> str:
        """One decoded token for `slot`: advance the position, record the
        token, retire at EOS/limit."""
        st = self.mgr.slots[slot]
        st.pos += 1
        rid = st.request_id
        self.outputs[rid].append(token)
        if (self.eos_id is not None and token == self.eos_id) or \
                len(self.outputs[rid]) >= self.max_new:
            self._retire(slot)
        else:
            self._new_tokens[slot] = token
        return rid

    def drain(self) -> Dict[str, List[int]]:
        """Hand over (and forget) every finished request's output; under
        continuous serving this keeps `outputs` bounded."""
        done = {}
        for rid in self._finished:
            if rid in self.outputs:
                done[rid] = self.outputs.pop(rid)
        self._finished.clear()
        return done

    # -- request path --------------------------------------------------------
    def submit(self, request_id: str, prompt: np.ndarray) -> int:
        """prompt: (S,) ints. Prefills into a fresh slot; the slot is
        already retired on return when the prefill token finishes the
        request (max_new == 1 / EOS on token #1)."""
        prompt = np.asarray(prompt)
        slot = self.mgr.admit(request_id, prompt_len=prompt.shape[-1],
                              max_new=self.max_new)
        inputs = torch.as_tensor(prompt, device=self.device)[None]
        tok, cache, pos = self._prefill(self.params, inputs)
        self.mgr.write_prefill(slot, cache, int(pos))
        self._record_first(request_id, slot, int(tok[0]))
        return slot

    def _decode_slots(self, slots: List[int], pos: int) -> List[int]:
        """One decode call for `slots`, all at position `pos`."""
        toks = torch.tensor([[self._new_tokens[i]] for i in slots],
                            dtype=torch.int64, device=self.device)
        lo = slots[0]
        if slots == list(range(lo, lo + len(slots))):
            # contiguous slots: decode on a view, written in place
            sub = tree_map(lambda c: c[:, lo:lo + len(slots)],
                           self.mgr.cache)
            nxt, _ = self._decode(self.params, toks, sub, pos)
        else:
            sel = torch.as_tensor(slots, device=self.device)
            sub = tree_map(lambda c: c[:, sel], self.mgr.cache)
            nxt, sub = self._decode(self.params, toks, sub, pos)
            for dst, src in zip(tree_leaves(self.mgr.cache),
                                tree_leaves(sub)):
                dst[:, sel] = src
        self.decode_calls += 1
        return nxt[:, 0].tolist()

    def tick(self) -> Dict[str, int]:
        """One decode step over every active slot, one decode call per
        distinct position."""
        act = self.mgr.active()
        if not act:
            return {}
        emitted: Dict[str, int] = {}
        by_pos: Dict[int, List[int]] = {}
        for i in act:
            by_pos.setdefault(self.mgr.slots[i].pos, []).append(i)
        for pos, slots in by_pos.items():
            nxt = self._decode_slots(slots, pos)
            for i, tok in zip(slots, nxt):
                emitted[self._emit(i, tok)] = tok
        return emitted

    def run_until_drained(self, max_ticks: int = 256):
        for _ in range(max_ticks):
            if not self.mgr.active():
                break
            self.tick()
        return self.outputs
