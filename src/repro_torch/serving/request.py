"""Requests and synthetic workloads (``repro.serving.request`` plus
``poisson_arrivals`` from ``repro.serving.trace``), numpy only."""

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

    def decode_gaps(self) -> np.ndarray:
        """Inter-token gaps over the decode phase."""
        if not self.token_times or len(self.token_times) < 2:
            return np.zeros(0)
        return np.diff(np.asarray(self.token_times, float))


@dataclasses.dataclass
class WorkloadSpec:
    """ShareGPT-replay style lengths (paper: avg input 16, avg output 256)."""

    mean_input: float = 16.0
    mean_output: float = 256.0
    vocab_size: int = 32_000
    max_input: int = 512
    max_output: int = 2048
    seed: int = 0


def sample_lengths(spec: WorkloadSpec, n: int, rng: np.random.Generator):
    """Lognormal (sigma 1) lengths scaled to the spec's means, clipped."""
    ins = rng.lognormal(mean=0.0, sigma=1.0, size=n)
    ins = np.clip((ins / ins.mean() * spec.mean_input).astype(int) + 1, 1, spec.max_input)
    outs = rng.lognormal(mean=0.0, sigma=1.0, size=n)
    outs = np.clip((outs / outs.mean() * spec.mean_output).astype(int) + 1, 1, spec.max_output)
    return ins, outs


def sample_requests(spec: WorkloadSpec, arrivals: np.ndarray, with_prompts: bool = False) -> List[Request]:
    """One request per arrival time, lengths from :func:`sample_lengths`."""
    rng = np.random.default_rng(spec.seed)
    n = len(arrivals)
    ins, outs = sample_lengths(spec, n, rng)
    reqs = []
    for i, t in enumerate(np.sort(arrivals)):
        prompt = None
        if with_prompts:
            prompt = rng.integers(0, spec.vocab_size, size=int(ins[i]), dtype=np.int32)
        reqs.append(
            Request(rid=i, arrival=float(t), input_len=int(ins[i]), output_len=int(outs[i]),
                    prompt=prompt, token_times=[])
        )
    return reqs


def poisson_arrivals(rate: float, duration: float, seed: int = 0) -> np.ndarray:
    """Constant-rate Poisson arrivals over [0, duration) seconds."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(rate * duration)
    return np.sort(rng.uniform(0, duration, size=n))
