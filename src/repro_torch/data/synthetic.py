"""Mechanistic long-form streaming user simulator (the JAX package's
``data/synthetic.py``, copied bit for bit).

No public Tubi logs exist, so the paper's A/B result is reproduced against a
generative user model built to contain exactly the mechanisms the paper's
claims depend on:

* **Intra-day intent drift** — each user has a stable long-term genre
  preference (dirichlet) plus a *session intent* (single active genre) that
  switches between sessions with probability ``p_switch``. A batch feature
  snapshot from last midnight cannot see today's intent switches; the
  real-time buffer can — this is the freshness gap the paper closes.
* **Organic discovery** — some watches happen off-slate (search / browse);
  they reveal intent to the real-time service even when slates are bad,
  which is what makes injection informative *within* a session.
* **Feedback loop** — training logs are generated under the then-deployed
  recommender, so a next-generation model partially fits the previous
  model's slate distribution. This is the mechanism the paper invokes to
  explain the consistent-features variant's null result (§IV).
* **Series binge chains** — long-form catalogs are dominated by episodic
  series: after watching episode e the user auto-continues to e+1 with
  probability ``p_binge`` via the Continue-Watching row (an ORGANIC,
  unattributed watch), and never picks continuations or mid-series entry
  points from the generic discovery slates. Intra-day logs are therefore
  saturated with mechanical e→e+1 transitions; a model trained WITH fresh
  recent-watch features (the paper's consistent variant) learns mostly to
  predict continuations — watches that happen anyway and earn a discovery
  slate nothing. This is the concrete form of the paper's hypothesis that
  such training "fits previous model recommendation / what the user would
  watch anyway instead of learning what the user really likes".

Engagement metric = slate CTR (attributed watches / impressions), the
closest observable analogue of the paper's "key user engagement metrics".

Everything is seeded numpy on the host; model scoring is batched into one
serve call per group of sessions by the pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

DAY = 86400


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    n_items: int = 5000
    n_genres: int = 8
    n_users: int = 1500
    seed: int = 0
    # session structure
    sessions_per_day: float = 2.5       # poisson mean
    rounds_per_session: int = 3         # slate impressions per session
    slate_size: int = 10
    # behaviour
    p_switch: float = 0.55              # intent switch prob between sessions
    p_organic: float = 0.25             # off-slate (search) watch per round
    affinity_long: float = 1.0          # weight of long-term preference
    affinity_intent: float = 3.0        # weight of session intent (drift!)
    affinity_pop: float = 0.3
    # long-form is watch-once: a large utility penalty for items the user
    # has already watched (without it, arms that exclude just-watched items
    # from slates — any fresh-feature arm — are unfairly punished, since
    # re-watches are free CTR for the stale arm).
    rewatch_penalty: float = 6.0
    choice_temp: float = 1.0
    # positional trust bias (regime B of §Paper-claims): conditional on
    # engaging with a slate, users satisfice from the top slots rather than
    # optimizing affinity. This makes the *deployed policy's ranking* a
    # strong label signal in intra-day logs — the paper's hypothesized
    # mechanism for the consistent variant's null ("training fits previous
    # model recommendation instead of learning what user really like").
    # 0.0 = pure affinity choice (regime A).
    trust_bias: float = 0.0
    # slate skipped if nothing beats this. Calibrated so a popularity policy
    # lands at CTR≈0.28 and a true-affinity oracle at ≈0.49 — the headroom
    # in which slate quality (and hence freshness) is measurable.
    skip_utility: float = 5.0
    # item space
    zipf_a: float = 1.1
    genre_concentration: float = 0.2    # dirichlet alpha for item genre mix
    # episodic structure (long-form): fraction of the catalog arranged in
    # series of ``series_len`` consecutive item ids; the rest are movies.
    series_frac: float = 0.6
    series_len: int = 6
    p_binge: float = 0.55               # continue-to-next-episode prob
    # users don't start a series mid-season from a discovery slate, and
    # they take continuations from the Continue-Watching row, not slates —
    # recommending either wastes the slate slot.
    midseries_penalty: float = 6.0


@dataclasses.dataclass
class Event:
    user: int
    item: int
    ts: int
    attributed: bool  # True if the watch came from a served slate


class World:
    """Static item/user space + per-user latent intent state."""

    def __init__(self, cfg: WorldConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        g = cfg.n_genres
        # episodic series layout: items [0, n_series*series_len) are
        # episodes (consecutive ids within a series share its genre)
        self.series_len = cfg.series_len
        self.n_series = int(cfg.n_items * cfg.series_frac / cfg.series_len)
        self.n_episode_items = self.n_series * cfg.series_len
        # items: sparse genre mixtures with one dominant genre
        primary = rng.randint(0, g, cfg.n_items)
        series_genre = rng.randint(0, g, self.n_series)
        for s_id in range(self.n_series):
            lo = s_id * cfg.series_len
            primary[lo:lo + cfg.series_len] = series_genre[s_id]
        mix = rng.dirichlet([cfg.genre_concentration] * g, cfg.n_items)
        boost = np.zeros((cfg.n_items, g))
        boost[np.arange(cfg.n_items), primary] = 1.0
        self.item_genre = 0.35 * mix + 0.65 * boost  # (V, G)
        self.item_primary = primary
        ranks = rng.permutation(cfg.n_items) + 1
        pop = 1.0 / ranks ** cfg.zipf_a
        self.popularity = pop / pop.sum()  # (V,)
        # users: long-term genre preference
        self.user_long = rng.dirichlet([0.5] * g, cfg.n_users)  # (U, G)
        # mutable per-user session intent (genre index)
        self.intent = np.array([
            rng.choice(g, p=self.user_long[u]) for u in range(cfg.n_users)])
        # watch-once memory (long-form): items already seen per user
        self.watched = [set() for _ in range(cfg.n_users)]
        # pending next-episode per user (the Continue-Watching row)
        self.continuations = [set() for _ in range(cfg.n_users)]

    # ------------------------------------------------------------------
    def affinity(self, user: int, items: np.ndarray) -> np.ndarray:
        """Current true affinity of `user` for `items` (higher = better)."""
        c = self.cfg
        ig = self.item_genre[items]  # (n, G)
        long_term = ig @ self.user_long[user]
        intent = ig[:, self.intent[user]]
        pop = np.log(self.popularity[items] * c.n_items + 1e-9)
        aff = (c.affinity_long * long_term + c.affinity_intent * intent +
               c.affinity_pop * pop)
        if c.rewatch_penalty and self.watched[user]:
            seen = np.fromiter((i in self.watched[user] for i in items),
                               bool, len(items))
            aff = aff - c.rewatch_penalty * seen
        if c.midseries_penalty:
            # continuations are taken from the CW row, never from discovery
            # slates; mid-season episodes are not entry points. Both waste
            # a discovery-slate slot.
            dead = np.fromiter(
                (self.is_midseries_entry(int(i), user)
                 or int(i) in self.continuations[user] for i in items),
                bool, len(items))
            aff = aff - c.midseries_penalty * dead
        return aff

    def record_watch(self, user: int, item: int) -> None:
        item = int(item)
        self.watched[user].add(item)
        self.continuations[user].discard(item)
        nxt = self.next_episode(item)
        if nxt is not None and nxt not in self.watched[user]:
            self.continuations[user].add(nxt)

    def next_episode(self, item: int):
        if item >= self.n_episode_items:
            return None  # a movie
        if (item + 1) % self.series_len == 0:
            return None  # season finale
        return item + 1

    def is_midseries_entry(self, item: int, user: int) -> bool:
        """Episode >1 that is NOT this user's pending continuation."""
        if item >= self.n_episode_items or item % self.series_len == 0:
            return False
        return item not in self.continuations[user]

    def maybe_switch_intent(self, user: int, rng: np.random.RandomState):
        if rng.rand() < self.cfg.p_switch:
            self.intent[user] = rng.choice(
                self.cfg.n_genres, p=self.user_long[user])

    def organic_item(self, user: int, rng: np.random.RandomState) -> int:
        """A search/browse watch aligned with the user's current intent."""
        genre_w = (self.item_genre[:, self.intent[user]] * self.popularity
                   ).copy()
        if self.watched[user]:
            genre_w[list(self.watched[user])] *= 1e-6  # watch-once
        # search lands on entry points (ep 1 / movies), not mid-season
        if self.n_episode_items:
            ep_idx = np.arange(self.n_episode_items) % self.series_len
            genre_w[:self.n_episode_items][ep_idx > 0] *= 1e-6
        genre_w = genre_w / genre_w.sum()
        return int(rng.choice(self.cfg.n_items, p=genre_w))

    def binge_chain(self, user: int, item: int, ts: int,
                    rng: np.random.RandomState):
        """Continue-Watching auto-continuation after a watch: a chain of
        organic next-episode events (the platform's CW row, not a slate)."""
        out = []
        cur = item
        while True:
            nxt = self.next_episode(int(cur))
            if nxt is None or nxt in self.watched[user]:
                break
            if rng.rand() >= self.cfg.p_binge:
                break
            ts += 600
            out.append((nxt, ts))
            self.record_watch(user, nxt)
            cur = nxt
        return out

    def choose_from_slate(self, user: int, slate: np.ndarray,
                          rng: np.random.RandomState) -> Optional[int]:
        """Multinomial choice over slate ∪ {skip}; returns item or None.

        The skip-vs-engage margin is always affinity-driven (users bail on
        rows that miss their mood — slate QUALITY moves CTR); with
        ``trust_bias`` > 0 the conditional WHICH-item choice is tilted
        toward the top positions (satisficing), transferring the deployed
        ranker's ordering into the logs.
        """
        c = self.cfg
        aff = self.affinity(user, slate)
        util = aff / c.choice_temp
        if c.trust_bias:
            n = len(slate)
            pos_bonus = c.trust_bias * (n - 1 - np.arange(n)) / max(n - 1, 1)
            util = util + pos_bonus
        util = np.concatenate([util, [c.skip_utility / c.choice_temp]])
        util -= util.max()
        p = np.exp(util)
        p /= p.sum()
        pick = rng.choice(len(slate) + 1, p=p)
        return None if pick == len(slate) else int(slate[pick])


# ----------------------------------------------------------------------
# Session schedule + day simulation
# ----------------------------------------------------------------------

def session_schedule(cfg: WorldConfig, day: int, rng: np.random.RandomState,
                     ) -> List[Tuple[int, int]]:
    """[(ts, user), ...] sorted by ts, for one day. Daytime-weighted.

    Columnar: one poisson draw for all users, one normal/randint draw for
    all sessions, one lexsort — no per-user Python loop.
    """
    base = day * DAY
    counts = rng.poisson(cfg.sessions_per_day, cfg.n_users)
    users = np.repeat(np.arange(cfg.n_users), counts)
    n = len(users)
    hours = np.clip(rng.normal(15, 5, n), 0.0, 23.9)  # afternoon peak
    tss = base + (hours * 3600).astype(np.int64) + rng.randint(0, 3600, n)
    order = np.lexsort((users, tss))
    return list(zip(tss[order].tolist(), users[order].tolist()))


def simulate_day(world: World, day: int, serve_fn: Callable,
                 observe_fn: Callable, *, seed: int,
                 serve_batch: int = 256) -> Tuple[List[Event], Dict[str, float]]:
    """Run one day of traffic.

    serve_fn(users (n,), ts (n,)) -> slates (n, slate_size) — the platform
    under test (an arm of the A/B). observe_fn(event) — feeds the platform's
    real-time service. Sessions at the same timestep are micro-batched into
    one serve call (realistic request batching, and fast under jit).

    Choice RNG is keyed by (user, session, round) so paired arms face
    identical user randomness — common-random-numbers variance reduction.
    """
    cfg = world.cfg
    sched_rng = np.random.RandomState(seed * 7919 + day)
    schedule = session_schedule(cfg, day, sched_rng)
    events: List[Event] = []
    impressions = 0
    slate_watches = 0
    sessions_with_click = 0
    user_impressions = np.zeros(cfg.n_users, np.int64)
    user_watches = np.zeros(cfg.n_users, np.int64)

    # group sessions into serving batches while preserving time order
    for i in range(0, len(schedule), serve_batch):
        group = schedule[i:i + serve_batch]
        for r in range(cfg.rounds_per_session):
            users = np.array([u for _, u in group])
            tss = np.array([ts + 60 * r for ts, _ in group])
            slates = serve_fn(users, tss)  # (n, slate)
            for (ts0, u), ts, slate in zip(group, tss, slates):
                if r == 0:
                    # keyed by session start: independent draw per session,
                    # identical across paired A/B arms (common random nums).
                    world.maybe_switch_intent(
                        u, np.random.RandomState((seed, day, u, ts0 % DAY, 17)))
                crng = np.random.RandomState((seed, day, u, ts0 % DAY, r))
                impressions += 1
                user_impressions[u] += 1
                pick = world.choose_from_slate(u, np.asarray(slate), crng)
                if pick is not None:
                    ev = Event(u, pick, int(ts), True)
                    events.append(ev)
                    observe_fn(ev)
                    world.record_watch(u, pick)
                    slate_watches += 1
                    user_watches[u] += 1
                    for it2, ts2 in world.binge_chain(u, pick, int(ts), crng):
                        ev2 = Event(u, it2, ts2, False)  # CW row, organic
                        events.append(ev2)
                        observe_fn(ev2)
                if crng.rand() < cfg.p_organic:
                    item = world.organic_item(u, crng)
                    ev = Event(u, item, int(ts) + 30, False)
                    events.append(ev)
                    observe_fn(ev)
                    world.record_watch(u, item)
                    for it2, ts2 in world.binge_chain(u, item, int(ts) + 30,
                                                      crng):
                        ev2 = Event(u, it2, ts2, False)
                        events.append(ev2)
                        observe_fn(ev2)
        # sessions with >=1 attributed watch
    # recompute session success from events
    by_session = {}
    for ev in events:
        if ev.attributed:
            by_session.setdefault((ev.user, ev.ts // 3600), 0)
            by_session[(ev.user, ev.ts // 3600)] += 1
    sessions_with_click = len(by_session)

    metrics = {
        "impressions": impressions,
        "slate_watches": slate_watches,
        "ctr": slate_watches / max(impressions, 1),
        "organic_watches": sum(1 for e in events if not e.attributed),
        "sessions_with_click": sessions_with_click,
        "user_impressions": user_impressions,
        "user_watches": user_watches,
    }
    return events, metrics


# ----------------------------------------------------------------------
# Bootstrap (pre-model) logging policy
# ----------------------------------------------------------------------

def bootstrap_serve_fn(world: World, seed: int) -> Callable:
    """Popularity-proportional slates with exploration — generation-0 policy
    that produces the initial training logs."""
    cfg = world.cfg
    rng = np.random.RandomState(seed)

    def serve(users, tss):
        n = len(users)
        slates = np.empty((n, cfg.slate_size), np.int64)
        for j in range(n):
            slates[j] = rng.choice(
                cfg.n_items, cfg.slate_size, replace=False, p=world.popularity)
        return slates

    return serve


def events_to_arrays(events: List[Event]) -> Dict[str, np.ndarray]:
    """Event list -> columnar arrays, the feature plane's native format
    (directly consumable by ``EventLog.extend`` / the store ``extend``s)."""
    n = len(events)
    return {
        "user": np.fromiter((e.user for e in events), np.int32, n),
        "item": np.fromiter((e.item for e in events), np.int32, n),
        "ts": np.fromiter((e.ts for e in events), np.int64, n),
        "attributed": np.fromiter((e.attributed for e in events), bool, n),
    }
