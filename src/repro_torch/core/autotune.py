"""Self-tuning transport (port of ``repro/core/autotune.py``): per-link
codec/frac selection from measured state.

Choice rule (evaluated at every encode, per link)::

    argmin_codec  expected_codec_bytes(codec, frac) * retx_factor
                  / measured_bandwidth  +  encode_cost(codec)

``retx_factor`` is the transport's geometric ``1/(1-drop_p)`` retransmit
tax (lossy links inflate the byte term, never the compute term) and
``encode_cost`` a per-parameter compute model: a fat link prefers ``raw``,
a starved one a top-k codec.  Simulated wire time charges bytes only; the
encode-cost term steers the *choice*.

Feedback (``Transport.note_round`` after every history point): a link
with no rate yet resolves to ``raw``; ``warmup_rounds`` forces extra dense
rounds on top; after warmup the top-k fraction starts at ``fracs[0]`` and
tightens one rung each time accuracy gains less than ``plateau_eps`` for
``plateau_window`` consecutive rounds.

The tuner owns no transport state: the transport consults it at encode
time (``resolve_up``/``resolve_down``) and for its byte estimates.  Pure
Python, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

# codecs the tuner may resolve to, cheapest-compute first: the argmin
# tie-break prefers the earlier entry, so equal-latency candidates fall
# back toward less codec machinery
_CANDIDATES = ("raw", "delta", "int8", "topk_ef", "topk_ef+int8")


@dataclass(frozen=True)
class AutoPolicy:
    """Static knobs of the auto codec mode (one policy per transport).

    The encode-cost coefficients are seconds per parameter per codec
    stage; they only steer *choice* (simulated transfer time stays
    bytes/bandwidth)."""
    warmup_rounds: int = 0            # forced dense rounds beyond the
    # structural warmup (first contact is raw regardless)
    fracs: Tuple[float, ...] = (0.1, 0.05)   # the top-k ladder
    plateau_eps: float = 1e-3         # accuracy gain counted as "moving"
    plateau_window: int = 3           # consecutive flat rounds per rung
    cost_pack: float = 1e-9           # s/param: pack + dense delta
    cost_topk: float = 8e-9           # s/param: threshold + sparsify pass
    cost_quant: float = 2e-9          # s/param: int8 quantise


class AutoTuner:
    """Per-transport codec/frac chooser.

    ``bind_bandwidth`` supplies the bandwidth sources: a per-link callable
    (worker/leaf id -> bytes/s, or None when nothing is known) and an
    optional representative callable for transport-wide byte estimates.
    A link with no rate from either source resolves to ``raw``."""

    def __init__(self, n_params: int, raw_bytes: int,
                 policy: Optional[AutoPolicy] = None):
        self.n_params = int(n_params)
        self.raw_bytes = int(raw_bytes)
        self.policy = policy or AutoPolicy()
        self.rounds = 0               # HistoryPoint feedback count
        self._frac_i = 0              # rung on the policy's frac ladder
        self._flat_streak = 0         # consecutive plateau rounds
        self._last_acc: Optional[float] = None
        self._bw_of: Optional[Callable[[str], Optional[float]]] = None
        self._rep_bw: Optional[Callable[[], Optional[float]]] = None

    # --- bandwidth sources ---
    def bind_bandwidth(self, per_link: Callable[[str], Optional[float]],
                       representative: Optional[Callable[[], Optional[float]]]
                       = None) -> None:
        self._bw_of = per_link
        self._rep_bw = representative

    # --- feedback schedule (HistoryPoint-driven) ---
    @property
    def frac(self) -> float:
        return self.policy.fracs[self._frac_i]

    @property
    def warming_up(self) -> bool:
        return self.rounds < self.policy.warmup_rounds

    def note_round(self, accuracy: float) -> None:
        """One aggregation round closed at ``accuracy``: advance the
        warmup counter and tighten the top-k rung after ``plateau_window``
        consecutive flat rounds."""
        self.rounds += 1
        p = self.policy
        if self._last_acc is not None:
            if accuracy - self._last_acc < p.plateau_eps:
                self._flat_streak += 1
                if (self._flat_streak >= p.plateau_window
                        and self._frac_i + 1 < len(p.fracs)):
                    self._frac_i += 1
                    self._flat_streak = 0
            else:
                self._flat_streak = 0
        self._last_acc = accuracy

    def carry_schedule(self, other: "AutoTuner") -> None:
        """Take over ``other``'s feedback schedule (warmup count, rung,
        plateau streak): a rebuilt transport continues the role's
        schedule, not the dead process's."""
        self.rounds = other.rounds
        self._frac_i = other._frac_i
        self._flat_streak = other._flat_streak
        self._last_acc = other._last_acc

    # --- the pricing rule ---
    def codec_bytes(self, name: str, frac: float) -> int:
        from .transport import CODECS, expected_codec_bytes
        return expected_codec_bytes(CODECS[name], self.n_params,
                                    self.raw_bytes, frac)

    def encode_cost(self, name: str) -> float:
        from .transport import CODECS
        spec = CODECS[name]
        if not spec.delta:
            return 0.0                # raw ships the weights untouched
        p = self.policy
        per_param = p.cost_pack
        if spec.topk:
            per_param += p.cost_topk
        if spec.quantize:
            per_param += p.cost_quant
        return self.n_params * per_param

    def expected_latency(self, name: str, frac: float, bw: float,
                         retx: float) -> float:
        """Expected one-transfer seconds of ``name`` on a ``bw`` bytes/s
        link with retransmit tax ``retx``: what the argmin minimises."""
        return (self.codec_bytes(name, frac) * retx / max(bw, 1.0)
                + self.encode_cost(name))

    def choose_for(self, bw: Optional[float], retx: float = 1.0
                   ) -> Tuple[str, float]:
        """(codec name, frac) minimising expected transfer latency at
        ``bw``; dense warmup and unmeasured links resolve to raw."""
        frac = self.frac
        if self.warming_up or not bw:
            return "raw", frac
        best = min(_CANDIDATES,
                   key=lambda n: self.expected_latency(n, frac, bw, retx))
        return best, frac

    def choose(self, worker_id: str, retx: float = 1.0) -> Tuple[str, float]:
        bw = self._bw_of(worker_id) if self._bw_of is not None else None
        return self.choose_for(bw, retx)

    def steady_choice(self, retx: float = 1.0) -> Tuple[str, float]:
        """The transport-wide choice (selection budgets price one scalar
        per round): the per-link rule at the representative bandwidth."""
        bw = self._rep_bw() if self._rep_bw is not None else None
        return self.choose_for(bw, retx)
