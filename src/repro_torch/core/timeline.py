"""The event timeline: one representation of time-varying step demand.

Port of ``repro.core.timeline`` (numpy, float64; host code with no torch).
The cluster scheduler's per-node reservations and the device programs that
batch them (``repro_torch.sim.device_timeline``) evaluate the same object:
the sum of concurrent Eq. (1) step reservations as a function of time,
probed at the instants where it can rise.

* **events**: sorted instants + demand deltas.  A reservation over
  ``[start, release)`` contributes ``+v_0`` at its start, each step delta at
  ``nextafter`` past its boundary (Eq. 1 steps are right-open), and
  ``-v_end`` at its release.
* **cumulative profile**: the running sum of deltas; the demand at ``t`` is
  ``cum[searchsorted(times, t, side="right")]`` -- always the value *after*
  every event tied at an instant, never a partial mid-tie sum that exists at
  no real time.
* **probes**: ``demand_exceeds`` / ``demand_exceeds_many`` evaluate a
  candidate reservation against the profile at the union of the candidate's
  own step-ups and the profile's events inside the window -- the only points
  where the combined step function can rise.  ``shared_probe_set`` builds the
  deduped probe union the batched programs dispatch on.

``Timeline`` (also exported as ``IncrementalDemandProfile``) maintains the
event arrays incrementally under add / add_many / remove / expire, keyed by
owner.  Event order, including the order of time-tied events
(``side="right"`` splices), is the reference's bit for bit: the device
programs seed their carried timelines from ``events()``.  Units follow
``core.allocation``: MiB, seconds, GiB*s.
"""

from __future__ import annotations

import numpy as np


def step_demand_profile(
    bnd: np.ndarray, val: np.ndarray, starts: np.ndarray, releases: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Total demand of R concurrent step reservations as a cumulative profile.

    Args:
      bnd: (R, kmax) boundaries, inf-padded past each reservation's k.
      val: (R, kmax + 1) values with hold-last padding (the extra column is
        the value held past the final boundary).
      starts: (R,) absolute reservation start times (inclusive).
      releases: (R,) absolute release times (exclusive: at ``releases[r]`` the
        reservation no longer counts).

    Returns (event times, cumulative demand): the total at time ``t`` is
    ``cum[np.searchsorted(times, t, side="right")]``.  Eq. (1) steps are
    right-open, so each step-up event sits at ``nextafter(switch)`` — the
    first representable instant the higher value applies (an absolute epsilon
    would underflow at large timestamps).
    """
    sw = starts[:, None] + bnd
    live = np.isfinite(bnd) & (sw < releases[:, None])
    steps = val[:, 1:] - val[:, :-1]  # (R, kmax), aligned with bnd
    # The released value must be derived from the same rounded switch times
    # as ``live`` (counting switches that actually fired), or rounding could
    # release a step that was never added and unbalance the profile forever.
    idx_end = np.sum(live, axis=1)
    v_end = np.take_along_axis(val, idx_end[:, None], axis=1)[:, 0]
    times = np.concatenate([starts, np.nextafter(sw[live], np.inf), releases])
    deltas = np.concatenate([val[:, 0], steps[live], -v_end])
    order = np.argsort(times, kind="stable")
    return times[order], np.concatenate([[0.0], np.cumsum(deltas[order])])


def demand_exceeds(
    times: np.ndarray,
    cum: np.ndarray,
    alloc,
    start: float,
    end: float,
    budget: float,
    *,
    inclusive_end: bool = False,
) -> bool:
    """Does profile demand + a candidate step reservation exceed ``budget``
    anywhere in [start, end) — or [start, end] with ``inclusive_end``?

    ``(times, cum)`` is a cumulative profile (``step_demand_profile`` /
    ``Timeline.arrays``); the candidate holds ``alloc`` (a
    ``core.allocation.StepAllocation``) from ``start``.  Demand is probed at
    the candidate's own step-ups (``nextafter`` past each boundary inside the
    window) and just after every profile event in the window — the only
    points where the combined step function can rise.  Cluster placement
    probes the right-open window (the candidate departs at ``end``);
    ``inclusive_end`` probes through the final boundary.
    """
    b = np.asarray(alloc.boundaries, dtype=np.float64)
    probes = np.concatenate([[start], np.nextafter(start + b[b < end - start], np.inf)])
    probes = probes[probes <= end] if inclusive_end else probes[probes < end]
    lo = np.searchsorted(times, start, side="right")  # events at start fold into the start probe
    hi = np.searchsorted(times, end, side="right" if inclusive_end else "left")
    t_all = np.concatenate([probes, times[lo:hi]])
    # Every probe — including the profile's own event times — reads the
    # cumulative sum AFTER all events tied at that instant (searchsorted
    # side="right"), never a partial mid-tie sum that exists at no real time.
    prof = cum[np.searchsorted(times, t_all, side="right")]
    return bool(np.any(prof + alloc.at(t_all - start) > budget))


def demand_exceeds_many(
    times: np.ndarray,
    cum: np.ndarray,
    alloc,
    starts: np.ndarray,
    duration: float,
    budget: float,
) -> np.ndarray:
    """``demand_exceeds`` vectorized over S candidate start times of ONE
    allocation, with the cluster scheduler's right-open window
    ``[start, start + duration)``.

    Evaluates the exact probe expressions of the scalar function — the start,
    each own switch instant passing both of its filters (``b < end - start``
    and ``probe < end``), and every profile event strictly inside the window,
    all read via ``searchsorted(..., "right")`` — so a True/False here is
    bit-identical to S scalar calls.  Used by the batched cluster scheduler's
    last-resort clock walk (``sim.cluster``) and as the oracle the device
    wait path is tested against.

    Returns a (S,) bool array: True where demand would exceed ``budget``.
    """
    b = np.asarray(alloc.boundaries, dtype=np.float64)
    v = np.asarray(alloc.values, dtype=np.float64)
    k = len(b)
    starts = np.asarray(starts, dtype=np.float64)
    ends = starts + duration

    def at(offsets):  # alloc.at, broadcast over any shape
        idx = np.minimum(np.searchsorted(b, offsets, side="left"), k - 1)
        return v[idx]

    # own probes: [start] + nextafter(start + b) under the scalar's filters
    p_sw = np.nextafter(starts[:, None] + b[None, :], np.inf)  # (S, k)
    ok_sw = (b[None, :] < (ends - starts)[:, None]) & (p_sw < ends[:, None])
    own_p = np.concatenate([starts[:, None], p_sw], axis=1)  # (S, k+1)
    own_ok = np.concatenate([np.ones((len(starts), 1), dtype=bool), ok_sw], axis=1)
    prof_own = cum[np.searchsorted(times, own_p, side="right")]
    over = np.any(own_ok & (prof_own + at(own_p - starts[:, None]) > budget), axis=1)
    # profile events strictly inside each window (the scalar's times[lo:hi]);
    # only the slice any window can reach participates in the (S, E) probe
    lo = np.searchsorted(times, starts.min(), side="right")
    hi = np.searchsorted(times, ends.max(), side="left")
    if hi > lo:
        ev = times[lo:hi]
        in_win = (ev[None, :] > starts[:, None]) & (ev[None, :] < ends[:, None])
        prof_ev = cum[np.searchsorted(times, ev, side="right")]  # after each tie group
        over |= np.any(in_win & (prof_ev[None, :] + at(ev[None, :] - starts[:, None]) > budget), axis=1)
    return over


def plan_profile_events(
    boundaries: np.ndarray, values: np.ndarray, start: float, release: float
) -> tuple[np.ndarray, np.ndarray]:
    """One reservation's demand events, exactly as ``step_demand_profile``
    derives them for a row: ``(times, deltas)`` sorted by time — the start
    (+v_0), each live switch at ``nextafter`` past its boundary (the step
    delta), and the release (-v_end, where v_end counts only switches that
    actually fired before ``release``).  The multiset of events produced for a
    reservation set equals ``step_demand_profile``'s, which is what lets
    ``Timeline`` maintain the same profile under add/remove instead of
    rebuilding it."""
    b = np.asarray(boundaries, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64)
    sw = start + b
    live = np.isfinite(b) & (sw < release)
    steps = np.append(np.diff(v), 0.0)  # step at the final boundary is 0 (hold-last)
    idx_end = int(np.sum(live))
    v_end = v[-1] if idx_end >= len(v) else v[idx_end]
    times = np.concatenate([[start], np.nextafter(sw[live], np.inf), [release]])
    deltas = np.concatenate([[v[0]], steps[live], [-v_end]])
    return times, deltas


def shared_probe_set(*parts: np.ndarray, return_inverse: bool = False):
    """The deduped probe union a batched program dispatches on.

    ``parts`` are arrays of absolute probe instants (profile events,
    candidate starts, switch instants ...).  Overlapping candidate boundaries
    and dyadic completion times repeat heavily, so the sorted-unique union is
    routinely a power-of-two bucket smaller than the raw concatenation —
    probes only sample step functions, so dropping duplicates cannot change
    any max.  With ``return_inverse`` the (concatenated-order) inverse
    mapping into the unique array is returned too, for callers that need to
    scatter per-probe results back to their sources."""
    cat = np.concatenate([np.ravel(np.asarray(p, dtype=np.float64)) for p in parts])
    if return_inverse:
        return np.unique(cat, return_inverse=True)
    return np.unique(cat)


class Timeline:
    """The event timeline maintained incrementally under add / remove /
    expire, keyed by owner.

    A full rebuild re-packs every reservation and re-sorts all events
    (O(R k + E log E) per mutation); this keeps the sorted event arrays live
    and merges one reservation's ~k+2 events in O(E + k) (``np.searchsorted``
    + one splice), recomputing the cumulative sum lazily in one O(E) pass.
    Event *values* are identical to the rebuilt profile's; only the order of
    time-tied events can differ, which probes never observe (they read the
    cumulative sum after all events tied at an instant, see
    ``step_demand_profile``) beyond float-summation rounding.

    Backing store of the batched scheduler's per-node state
    (``sim.device_timeline.schedule_epoch`` seeds its carried timelines
    from ``events()``), so every consumer reads one source of truth.  ``version``
    increments on every mutation that changes the event arrays — caches
    derived from them (the cumulative sum here, padded device buffers in
    callers) must key on it, including across ``expire`` calls that hit the
    min-release fast path and change nothing.
    """

    def __init__(self):
        self._times = np.empty(0, dtype=np.float64)
        self._deltas = np.empty(0, dtype=np.float64)
        self._codes = np.empty(0, dtype=np.int64)
        self._next_code = 0
        self._owners: dict = {}  # owner -> event code
        self._releases: dict = {}  # owner -> release time (for expire())
        self._cum: np.ndarray | None = None
        self._version = 0
        # lower bound on min(self._releases.values()); lets expire() return
        # without scanning the owner dict (the scheduler calls it per epoch).
        # Stale-low is safe: the fast path just isn't taken.
        self._min_release = np.inf

    @property
    def n_events(self) -> int:
        return len(self._times)

    @property
    def n_owners(self) -> int:
        return len(self._owners)

    @property
    def version(self) -> int:
        """Mutation counter: changes iff the event arrays changed."""
        return self._version

    def __contains__(self, owner) -> bool:
        return owner in self._owners

    def add(self, owner, boundaries: np.ndarray, values: np.ndarray, start: float, release: float) -> None:
        """Merge one reservation's events into the profile (O(E + k)) —
        the scalar twin of ``add_many``, skipping its batch plumbing."""
        if owner in self._owners:
            raise ValueError(f"owner(s) already hold a reservation: [{owner!r}]")
        t, d = plan_profile_events(boundaries, values, float(start), float(release))
        code = self._next_code
        self._next_code += 1
        self._owners[owner] = code
        self._releases[owner] = float(release)
        self._min_release = min(self._min_release, float(release))
        self._splice(t, d, np.full(len(t), code, dtype=np.int64))

    def add_many(self, owners, boundaries: np.ndarray, values: np.ndarray, starts, releases) -> None:
        """Merge R reservations in one pass: their events are concatenated
        (each reservation's own events are already time-sorted), sorted once,
        and spliced into the live arrays with a single insert — the batch
        commit path of the batched cluster scheduler's per-epoch placements (one O(E + R k log(R k)) splice per
        batch instead of R separate merges).

        Event construction is the fully-vectorized twin of
        ``plan_profile_events`` — row-major flattening keeps each row's
        events grouped in commit order, so with the stable time sort the
        spliced arrays are **bit-identical** to R sequential ``add`` calls
        (time-tied events land in the same order a ``side="right"`` insert
        would put them)."""
        owners = list(owners)
        dup = [o for o in owners if o in self._owners]
        if dup or len(set(owners)) != len(owners):
            raise ValueError(f"owner(s) already hold a reservation: {dup or owners!r}")
        R = len(owners)
        if R == 0:
            return
        b = np.asarray(boundaries, dtype=np.float64).reshape(R, -1)
        v = np.asarray(values, dtype=np.float64).reshape(R, -1)
        starts = np.asarray(starts, dtype=np.float64).reshape(R)
        rels = np.asarray(releases, dtype=np.float64).reshape(R)
        codes = np.arange(self._next_code, self._next_code + R, dtype=np.int64)
        self._next_code += R
        for o, c_, rl in zip(owners, codes, rels):
            self._owners[o] = int(c_)
            self._releases[o] = float(rl)
        self._min_release = min(self._min_release, float(rels.min()))
        sw = starts[:, None] + b
        live = np.isfinite(b) & (sw < rels[:, None])
        steps = np.concatenate([np.diff(v, axis=1), np.zeros((R, 1))], axis=1)
        vext = np.concatenate([v, v[:, -1:]], axis=1)
        v_end = np.take_along_axis(vext, np.sum(live, axis=1)[:, None], axis=1)[:, 0]
        times = np.concatenate([starts[:, None], np.nextafter(sw, np.inf), rels[:, None]], axis=1)
        deltas = np.concatenate([v[:, :1], steps, -v_end[:, None]], axis=1)
        mask = np.concatenate([np.ones((R, 1), bool), live, np.ones((R, 1), bool)], axis=1)
        m = mask.ravel()
        t = times.ravel()[m]
        d = deltas.ravel()[m]
        c = np.repeat(codes, mask.shape[1])[m]
        order = np.argsort(t, kind="stable")
        self._splice(t[order], d[order], c[order])

    def _splice(self, t: np.ndarray, d: np.ndarray, c: np.ndarray) -> None:
        """Merge time-sorted events into the live arrays — one manual splice
        for all three (np.insert's index normalization costs more than the
        merge itself at this size), ``side="right"`` so time-tied newcomers
        land after existing events."""
        E, n = len(self._times), len(t)
        pos = np.searchsorted(self._times, t, side="right") + np.arange(n)
        old_pos = np.ones(E + n, dtype=bool)
        old_pos[pos] = False
        times = np.empty(E + n)
        deltas = np.empty(E + n)
        codes = np.empty(E + n, dtype=np.int64)
        times[pos], times[old_pos] = t, self._times
        deltas[pos], deltas[old_pos] = d, self._deltas
        codes[pos], codes[old_pos] = c, self._codes
        self._times, self._deltas, self._codes = times, deltas, codes
        self._cum = None
        self._version += 1

    def remove(self, owner) -> None:
        """Drop one reservation's events (O(E)); no-op for unknown owners."""
        code = self._owners.pop(owner, None)
        if code is None:
            return
        self._releases.pop(owner, None)
        keep = self._codes != code
        self._times = self._times[keep]
        self._deltas = self._deltas[keep]
        self._codes = self._codes[keep]
        self._cum = None
        self._version += 1

    def expire(self, now: float) -> None:
        """Garbage-collect reservations fully released at or before ``now``.

        A released reservation's deltas telescope to zero past its release,
        so dropping its events cannot change any probe at ``t >= now`` —
        this only bounds the event count for long-running controllers.  The
        min-release fast path returns without touching the arrays, the
        cached cumulative sum, or ``version`` — a hit must leave every
        derived cache valid."""
        if now < self._min_release:
            return
        gone = [o for o, r in self._releases.items() if r <= now]
        if not gone:
            # restore the fast path for the next caller; nothing changed, so
            # caches (and version) stay untouched
            self._min_release = min(self._releases.values(), default=np.inf)
            return
        codes = np.asarray([self._owners.pop(o) for o in gone], dtype=np.int64)
        for o in gone:
            self._releases.pop(o, None)
        self._min_release = min(self._releases.values(), default=np.inf)
        keep = ~np.isin(self._codes, codes)
        self._times = self._times[keep]
        self._deltas = self._deltas[keep]
        self._codes = self._codes[keep]
        self._cum = None
        self._version += 1

    def events(self) -> tuple[np.ndarray, np.ndarray]:
        """(event times (E,), demand deltas (E,)) — the raw sorted event
        stream, the form the device scheduling program seeds its carry with
        (it maintains its own running sum).  Views of live arrays: treat as
        read-only; stale after any mutation (key on ``version``)."""
        return self._times, self._deltas

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(event times (E,), cumulative demand (E+1,)) — read exactly like
        ``step_demand_profile``'s output: the total at ``t`` is
        ``cum[np.searchsorted(times, t, side="right")]``."""
        if self._cum is None:
            self._cum = np.concatenate([[0.0], np.cumsum(self._deltas)])
        return self._times, self._cum

    def demand_at(self, t):
        """Total demand at instant(s) ``t`` (vectorized) — the canonical
        side="right" read of the cumulative profile."""
        times, cum = self.arrays()
        return cum[np.searchsorted(times, np.asarray(t), side="right")]

    def demand_exceeds(self, alloc, start: float, end: float, budget: float, *, inclusive_end: bool = False) -> bool:
        """``demand_exceeds`` against this timeline's cached profile."""
        times, cum = self.arrays()
        return demand_exceeds(times, cum, alloc, start, end, budget, inclusive_end=inclusive_end)

    def demand_exceeds_many(self, alloc, starts: np.ndarray, duration: float, budget: float) -> np.ndarray:
        """``demand_exceeds_many`` against this timeline's cached profile."""
        times, cum = self.arrays()
        return demand_exceeds_many(times, cum, alloc, starts, duration, budget)


# The reference's second name for the class.
IncrementalDemandProfile = Timeline
