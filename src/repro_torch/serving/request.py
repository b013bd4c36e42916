"""Requests, their SLO accounting and synthetic workloads
(``repro.serving.request``), numpy only.  The arrival processes and the
multi-tenant trace file are in :mod:`repro_torch.serving.trace`."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float  # seconds
    input_len: int
    output_len: int  # target generation length
    prompt: Optional[np.ndarray] = None  # token ids
    # admission deadline (absolute clock time): a request still waiting for a
    # slot or for prefill past it is rejected (``metrics()["rejected"]``)
    # instead of queuing unboundedly; None waits forever
    deadline: Optional[float] = None
    # runtime state
    slot: int = -1
    prefill_done: float = -1.0
    generated: int = 0
    token_times: Optional[List[float]] = None
    finished: float = -1.0
    # terminal admission rejection: the deadline passed before activation, so
    # the request holds no slot and emitted no tokens
    rejected: bool = False
    # context window exhausted before output_len tokens were generated
    truncated: bool = False
    # greedy token ids emitted (first from prefill, then one per decode step)
    tokens_out: Optional[List[int]] = None
    # -- multi-tenant and SLO fields (trace replay) --
    tenant: str = "default"
    klass: str = "chat"  # chat | long-context | batch-offline
    # higher wins under sched="priority": admitted first, and may preempt a
    # strictly lower-priority active slot (its KV spills, nothing is copied)
    priority: int = 0
    ttft_slo: Optional[float] = None  # seconds, arrival -> first token
    tpot_slo: Optional[float] = None  # seconds, p99 inter-token gap
    preemptions: int = 0  # times this request's slot was preempted
    # (spill_t, restore_t) spans parked off-batch between two of its tokens:
    # scheduling wait, which TPOT leaves out
    wait_spans: Optional[List[tuple]] = None

    def decode_gaps(self) -> np.ndarray:
        """Inter-token gaps over the decode phase, each preemption wait taken
        out of the gap it interrupted."""
        if not self.token_times or len(self.token_times) < 2:
            return np.zeros(0)
        times = np.asarray(self.token_times, float)
        gaps = np.diff(times)
        for a, b in self.wait_spans or []:
            i = int(np.searchsorted(times, a, side="right")) - 1
            if 0 <= i < len(gaps):
                gaps[i] = max(0.0, gaps[i] - (b - a))
        return gaps

    def tpot_p(self, q: float) -> float:
        """Percentile ``q`` of the decode gaps (preemption waits left out)."""
        gaps = self.decode_gaps()
        if not len(gaps):
            return 0.0
        return float(np.percentile(gaps, q))

    def ttft(self) -> Optional[float]:
        """Arrival -> first token, or None if the request was never served."""
        if self.prefill_done < 0:
            return None
        return self.prefill_done - self.arrival

    def slo_ok(self) -> Optional[bool]:
        """Did the request meet its SLOs?  None when it carries none; False
        when it was rejected or never served."""
        if self.ttft_slo is None and self.tpot_slo is None:
            return None
        if self.rejected or self.prefill_done < 0:
            return False
        if self.ttft_slo is not None and self.ttft() > self.ttft_slo:
            return False
        if self.tpot_slo is not None and self.tpot_p(99.0) > self.tpot_slo:
            return False
        return True


@dataclasses.dataclass
class WorkloadSpec:
    """ShareGPT-replay style lengths (paper: avg input 16, avg output 256)."""

    mean_input: float = 16.0
    mean_output: float = 256.0
    vocab_size: int = 32_000
    max_input: int = 512
    max_output: int = 2048
    seed: int = 0
    # every prompt opens with the same ``shared_prefix_len`` tokens (a
    # fleet-wide system prompt) before its own tail; the sampled lengths
    # above size the tails
    shared_prefix_len: int = 0


def long_prompt_spec(**overrides) -> WorkloadSpec:
    """Long-prompt preset (document QA / RAG): heavy-tailed prompts, short
    generations."""
    spec = dict(mean_input=512.0, mean_output=64.0, max_input=4096, max_output=256)
    spec.update(overrides)
    return WorkloadSpec(**spec)


def shared_prefix_spec(**overrides) -> WorkloadSpec:
    """Shared-system-prompt preset (assistant and agent fleets): one long
    system prompt, then a short user turn of each request's own."""
    spec = dict(mean_input=8.0, mean_output=24.0, max_input=32, max_output=64, shared_prefix_len=48)
    spec.update(overrides)
    return WorkloadSpec(**spec)


def sample_lengths(spec: WorkloadSpec, n: int, rng: np.random.Generator):
    """Lognormal (sigma 1) lengths scaled to the spec's means, clipped."""
    ins = rng.lognormal(mean=0.0, sigma=1.0, size=n)
    ins = np.clip((ins / ins.mean() * spec.mean_input).astype(int) + 1, 1, spec.max_input)
    outs = rng.lognormal(mean=0.0, sigma=1.0, size=n)
    outs = np.clip((outs / outs.mean() * spec.mean_output).astype(int) + 1, 1, spec.max_output)
    return ins, outs


def expected_tokens_per_request(spec: WorkloadSpec, n: int = 4096) -> float:
    """Mean output length of ``spec``, through :func:`sample_lengths`."""
    _ins, outs = sample_lengths(spec, n, np.random.default_rng(spec.seed))
    return float(outs.mean())


def sample_requests(spec: WorkloadSpec, arrivals: np.ndarray, with_prompts: bool = False) -> List[Request]:
    """One request per arrival time, lengths from :func:`sample_lengths`; a
    shared prefix is drawn after the lengths and before the prompts (the
    reference's draw order, so streams without one are unchanged)."""
    rng = np.random.default_rng(spec.seed)
    n = len(arrivals)
    ins, outs = sample_lengths(spec, n, rng)
    shared = None
    if spec.shared_prefix_len > 0:
        shared = rng.integers(0, spec.vocab_size, size=spec.shared_prefix_len, dtype=np.int32)
    reqs = []
    for i, t in enumerate(np.sort(arrivals)):
        prompt = None
        if with_prompts:
            prompt = rng.integers(0, spec.vocab_size, size=int(ins[i]), dtype=np.int32)
            if shared is not None:
                prompt = np.concatenate([shared, prompt])
        reqs.append(
            Request(rid=i, arrival=float(t), input_len=int(ins[i]) + spec.shared_prefix_len,
                    output_len=int(outs[i]), prompt=prompt, token_times=[])
        )
    return reqs


def __getattr__(name):
    # poisson_arrivals lives in serving/trace.py, as in the reference; it is
    # still importable from here
    if name == "poisson_arrivals":
        from repro_torch.serving.trace import poisson_arrivals

        return poisson_arrivals
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
