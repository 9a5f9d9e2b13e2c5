"""Per-input completion-time estimation: the Shabari insight applied
to the front door's forecasts.

The router's estimate-mode scoring and SLO-native admission both hinge
on a per-function UNCONTENDED exec-time estimate. A per-function EWMA
(the original estimator, kept as the cold prior and the
``SimConfig(estimate_features=False)`` A/B fallback) is input-blind: on
a heavy-tailed input distribution it forecasts the mean for every
invocation, so the large inputs that actually decide SLO compliance are
systematically under-estimated — exactly the "static config can't see
the input" failure mode the paper measures (§3) for allocation, and
Bilal et al. (arXiv 2105.14845) quantify for right-sizing.

:class:`ECTRegressor` replaces the point estimate with a small online
regressor per function over the invocation's ALREADY-COMPUTED feature
vector — the standardized :class:`repro_torch.core.featurizer.Featurizer`
output plus log1p(input MB) that ride the retry payload as the policy's
``aux`` cache — so no extra critical-path featurization is spent on the
estimate. The model is linear in log-exec space (the §2.1 size→time
relations are multiplicative), trained by AdaGrad on squared error, and
deterministic given the observation order, so estimate-mode runs stay
reproducible under a fixed seed.

Safeguards, each pinned by tests/test_ect_admission.py:

* cold prior — below ``ECT_WARMUP_OBS`` observations the regressor
  abstains (:meth:`predict` returns None) and callers fall back to the
  EWMA prior;
* clamp — a prediction may move at most ``ECT_CLAMP``x off the EWMA
  prior, so one early outlier cannot fling the forecast (and with it
  SLO admission) orders of magnitude away;
* dimension guard — a function whose feature schema changes mid-run
  (clone aliases, formulation sweeps) resets its state instead of
  dotting mismatched shapes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

# observations before the regressor overrides the EWMA cold prior
ECT_WARMUP_OBS = 8
# AdaGrad step size on the squared log-space error
ECT_LR = 0.5
# max multiplicative distance a prediction may move off the EWMA prior
ECT_CLAMP = 8.0
# admission="slo" safety factor on a TRAINED per-input estimate: shed
# only when the irreducible forecast exceeds this multiple of the SLO
# budget, so estimator noise (~20% median multiplicative error) cannot
# shed servable work sitting near its SLO (build_slo_table sets SLOs at
# 1.4x best-case exec, putting a large mass of invocations in exactly
# that gray zone)
ECT_SLO_MARGIN = 2.0
# how far the per-input shed margin widens with the regressor's own
# measured log error: effective margin = ECT_SLO_MARGIN x
# exp(ECT_ERR_WIDEN x (err + ECT_ERR_PRIOR / sqrt(n))). The model's
# accuracy is function-specific — a function whose exec the features
# explain well (err -> 0) sheds at the base margin, while one the model
# keeps mispredicting (err ~ log 3) effectively never per-input-sheds,
# however confident a single prediction looks
ECT_ERR_WIDEN = 2.0
# EWMA weight on the per-observation |log prediction error| feed
ECT_ERR_ALPHA = 0.3
# the youth term of the margin's error bound: a just-warmed model's few
# observations understate its true error (the EWMA has barely sampled
# the input distribution), so the bound decays as 1/sqrt(n) like a
# confidence radius instead of trusting the point estimate outright
ECT_ERR_PRIOR = 2.0
# admission="slo" band for an INPUT-BLIND estimate (the EWMA, or a
# regressor echoing its prior): a mean-of-the-distribution forecast can
# sit an order of magnitude above the smallest inputs' exec times (the
# scenario suite's widest function spans ~13x around its mean), so the
# blind path sheds only when even an input that favorable would blow
# the budget
ECT_BLIND_SHED_BAND = 32.0
# observations before admission="slo" trusts ANY estimate enough to
# shed on it. Shedding is irreversible (the work is dropped), so it
# demands a far higher calibration bar than routing: a few heavy first
# draws can hold the early EWMA an order of magnitude above its
# steady-state mean, and a just-warmed regressor is still confidently
# wrong on inputs it has not seen. Budget-expired invocations are shed
# regardless — no estimate is involved in that decision.
ECT_SHED_OBS = 32


@dataclasses.dataclass
class _FnState:
    w: np.ndarray  # bias + feature dims + log1p(input MB)
    g2: np.ndarray  # AdaGrad accumulators, same shape
    n: int = 0
    # EWMA of the model's PRE-UPDATE |log error| on each observation —
    # an honest one-step-ahead accuracy track (the model never grades
    # itself on a point it has already trained on)
    err: float = 0.0


class ECTRegressor:
    """Per-function online regression of log uncontended exec seconds
    on the invocation's feature vector."""

    def __init__(self):
        self._state: Dict[str, _FnState] = {}

    @staticmethod
    def _design(features: np.ndarray, input_mb: float) -> np.ndarray:
        x = np.asarray(features, dtype=np.float64).ravel()
        return np.concatenate(
            ([1.0], x, [math.log1p(max(float(input_mb), 0.0))])
        )

    def observations(self, function: str) -> int:
        st = self._state.get(function)
        return 0 if st is None else st.n

    def log_error(self, function: str) -> float:
        """Upper bound on the model's one-step-ahead |log prediction
        error| for the function: the observed-error EWMA plus a
        ``ECT_ERR_PRIOR / sqrt(n)`` youth term (infinite before any
        observation). exp() of this is the typical multiplicative miss —
        admission widens its shed margin by it."""
        st = self._state.get(function)
        if st is None or st.n == 0:
            return math.inf
        return st.err + ECT_ERR_PRIOR / math.sqrt(st.n)

    def observe(self, function: str, features: np.ndarray, input_mb: float,
                exec_s: float, prior_s: float) -> None:
        """Fold one completed invocation's uncontended exec time into
        the function's regressor (non-positive times are ignored, like
        the EWMA path). The model learns the log RESIDUAL off
        ``prior_s`` (the function's EWMA at observation time), not the
        absolute log time: an untrained model then predicts exactly the
        prior instead of an arbitrary point inside the clamp band, so
        early-training noise degrades gracefully toward the input-blind
        estimator rather than away from it."""
        if exec_s <= 0.0 or prior_s <= 0.0:
            return
        phi = self._design(features, input_mb)
        st = self._state.get(function)
        if st is None or st.w.shape[0] != phi.shape[0]:
            st = _FnState(w=np.zeros(phi.shape[0]),
                          g2=np.zeros(phi.shape[0]))
            self._state[function] = st
        err = float(phi @ st.w) - (math.log(exec_s) - math.log(prior_s))
        st.err = (abs(err) if st.n == 0
                  else (1.0 - ECT_ERR_ALPHA) * st.err
                  + ECT_ERR_ALPHA * abs(err))
        grad = err * phi
        st.g2 += grad * grad
        st.w -= ECT_LR * grad / np.sqrt(st.g2 + 1e-12)
        st.n += 1

    def predict(self, function: str, features: np.ndarray, input_mb: float,
                prior_s: float) -> Optional[float]:
        """The function's per-input exec estimate — the EWMA prior
        scaled by the learned per-input residual — or None while the
        regressor is still inside its warm-up (callers fall back to
        ``prior_s``). Predictions are clamped to within ``ECT_CLAMP``x
        of the prior."""
        st = self._state.get(function)
        if st is None or st.n < ECT_WARMUP_OBS:
            return None
        phi = self._design(features, input_mb)
        if phi.shape[0] != st.w.shape[0]:
            return None
        est = prior_s * math.exp(float(phi @ st.w))
        return min(max(est, prior_s / ECT_CLAMP), prior_s * ECT_CLAMP)
