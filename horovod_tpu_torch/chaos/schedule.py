"""Deterministic fault schedules: the rule grammar and matching engine.

A :class:`FaultSchedule` is a seed plus an ordered list of declarative
rules.  Each rule names an injection *site* (``rpc.request``, ``kv.set``,
``discovery.find``, ``engine.cycle``, ...), optional match conditions on
the site's context, a firing predicate (``nth``/``every``/``times``/
``prob``/``after``), and an *action* (``drop``, ``delay``, ``dup``,
``http500``, ``reset``, ``error``, ``crash``, ``stale``, ``flap``).

Grammar (one rule per line or ``;``-separated; ``action=`` is always
the last token — its ``:<arg>`` may contain spaces)::

    <site>[:<method>] [key=value ...] action=<kind>[:<arg>]

Examples::

    rpc.request:running nth=1 action=drop
    rpc.request prob=0.2 action=delay:0.05
    kv.dir_get every=7 action=stale
    discovery.find nth=2 action=error:transient poll failure
    worker.running worker_id=2 nth=1 action=crash:17

Match conditions compare ``str(ctx[key]) == value``; the ``:<method>``
qualifier is shorthand for ``method=<value>``.  Firing predicates:

* ``nth=K``    — fire only on the K-th match of this rule (1-based)
* ``every=K``  — fire on every K-th match
* ``times=K``  — fire at most K times total
* ``after=K``  — only consider matches beyond the first K
* ``prob=P``   — fire with probability P from the rule's own seeded RNG

Determinism: every rule owns a ``random.Random`` seeded from
``(schedule seed, rule index, rule text)``, and match counters advance
only on matches — the same schedule over the same event sequence fires
identically every run.  Probabilistic rules are deterministic *given* the
event order; fully event-order-independent schedules use ``nth``/``every``.

Counterpart: ``horovod_tpu/chaos/schedule.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import json
import random
import threading
from typing import Dict, List, Optional, Tuple

_FIRING_KEYS = ("nth", "every", "times", "after", "prob")

#: Every action kind fire() executes or an injection point interprets.
#: Parse-time validation against this set keeps the fail-loud contract:
#: a typo'd action must raise at install, not silently inject nothing.
#: ``nan``/``scale`` belong to the ``collective.corrupt`` site (value
#: corruption of a chosen bucket on a chosen rank — health/taps.py).
KNOWN_ACTIONS = frozenset((
    "delay", "drop", "reset", "http500", "error", "crash",
    "dup", "stale", "flap", "drop-reply", "nan", "scale",
))


class Action:
    """A fault decision handed back to (or executed for) an injection
    point.  ``kind`` is the action name; ``arg`` its optional ``:arg``
    suffix, unparsed; ``rule`` the text of the rule that fired (the
    chaos→metrics bridge labels injection counts with it)."""

    __slots__ = ("kind", "arg", "site", "rule")

    def __init__(self, kind: str, arg: Optional[str] = None,
                 site: str = "", rule: str = ""):
        self.kind = kind
        self.arg = arg
        self.site = site
        self.rule = rule

    def arg_float(self, default: float) -> float:
        try:
            return float(self.arg)
        except (TypeError, ValueError):
            return default

    def arg_int(self, default: int) -> int:
        try:
            return int(self.arg)
        except (TypeError, ValueError):
            return default

    def __repr__(self):
        return (f"Action({self.kind!r}"
                + (f", {self.arg!r}" if self.arg is not None else "")
                + f" @ {self.site})")


class FaultRule:
    """One parsed rule.  Counters (``seen``/``count_fired``) live here so
    ``nth``/``every``/``times`` are per-rule, not per-site."""

    def __init__(self, site: str, matchers: Dict[str, str],
                 action: str, action_arg: Optional[str],
                 nth: Optional[int] = None, every: Optional[int] = None,
                 times: Optional[int] = None, after: int = 0,
                 prob: Optional[float] = None, text: str = ""):
        self.site = site
        self.matchers = dict(matchers)
        self.action = action
        self.action_arg = action_arg
        self.nth = nth
        self.every = every
        self.times = times
        self.after = after
        self.prob = prob
        self.text = text or self._unparse()
        self.seen = 0          # matches observed
        self.count_fired = 0   # injections performed
        self._rng = random.Random(0)   # reseeded by FaultSchedule

    @classmethod
    def parse(cls, text: str) -> "FaultRule":
        tokens = text.split()
        if not tokens:
            raise ValueError("empty fault rule")
        site = tokens[0]
        matchers: Dict[str, str] = {}
        if ":" in site:
            site, method = site.split(":", 1)
            matchers["method"] = method
        # action= terminates the rule: an action ARGUMENT may contain
        # spaces (action=error:transient poll failure), so everything
        # after the ':' — including later tokens — belongs to it
        action = action_arg = None
        head = tokens[1:]
        for i, tok in enumerate(head):
            if tok.startswith("action="):
                kind, sep, arg = tok[len("action="):].partition(":")
                tail = head[i + 1:]
                if sep:
                    action_arg = " ".join([arg] + tail) if tail else arg
                elif tail:
                    raise ValueError(
                        f"tokens after argument-less action in {text!r}; "
                        f"action= must be the last token")
                action = kind
                head = head[:i]
                break
        if not action:
            raise ValueError(f"fault rule {text!r} has no action=")
        if action not in KNOWN_ACTIONS:
            raise ValueError(
                f"unknown action {action!r} (in {text!r}); known: "
                f"{sorted(KNOWN_ACTIONS)}")
        nth = every = times = prob = None
        after = 0
        for tok in head:
            if "=" not in tok:
                raise ValueError(
                    f"fault rule token {tok!r} is not key=value (in "
                    f"{text!r})")
            key, val = tok.split("=", 1)
            if key in _FIRING_KEYS:
                try:
                    if key == "prob":
                        prob = float(val)
                    elif key == "nth":
                        nth = int(val)
                    elif key == "every":
                        every = int(val)
                    elif key == "times":
                        times = int(val)
                    else:
                        after = int(val)
                except ValueError:
                    raise ValueError(
                        f"fault rule {key}={val!r} is not numeric (in "
                        f"{text!r})") from None
            else:
                matchers[key] = val
        # validate at parse so a bad spec fails loudly at install, not
        # with an arbitrary exception at some mid-run injection point
        if nth is not None and nth < 1:
            raise ValueError(f"nth must be >= 1 (in {text!r})")
        if every is not None and every < 1:
            raise ValueError(f"every must be >= 1 (in {text!r})")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1 (in {text!r})")
        if after < 0:
            raise ValueError(f"after must be >= 0 (in {text!r})")
        if prob is not None and not 0.0 <= prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1] (in {text!r})")
        return cls(site, matchers, action, action_arg, nth=nth,
                   every=every, times=times, after=after, prob=prob,
                   text=" ".join(tokens))

    def _unparse(self) -> str:
        parts = [self.site]
        parts += [f"{k}={v}" for k, v in sorted(self.matchers.items())]
        parts.append(f"action={self.action}"
                     + (f":{self.action_arg}" if self.action_arg else ""))
        return " ".join(parts)

    def matches(self, site: str, ctx: Dict) -> bool:
        if site != self.site:
            return False
        for key, want in self.matchers.items():
            if key not in ctx or str(ctx[key]) != want:
                return False
        return True

    def should_fire(self) -> bool:
        """Firing predicate over the just-incremented ``seen`` counter.
        Caller (the schedule) holds the schedule lock."""
        if self.times is not None and self.count_fired >= self.times:
            return False
        if self.seen <= self.after:
            return False
        n = self.seen - self.after
        if self.nth is not None:
            return n == self.nth
        if self.every is not None:
            return n % self.every == 0
        if self.prob is not None:
            return self._rng.random() < self.prob
        return True


class FaultSchedule:
    """Seeded, ordered fault rules; thread-safe decision engine.

    Every injection performed is appended to :attr:`fired` as
    ``(site, action kind, ctx)`` so tests can assert exactly which faults
    a run experienced.
    """

    def __init__(self, rules=(), seed: int = 0):
        self.seed = int(seed)
        self.rules: List[FaultRule] = [
            FaultRule.parse(r) if isinstance(r, str) else r
            for r in rules]
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str, Dict]] = []
        for i, rule in enumerate(self.rules):
            rule._rng = random.Random(f"{self.seed}:{i}:{rule.text}")

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultSchedule":
        """Build a schedule from a text or JSON spec.

        Text: rules separated by newlines or ``;`` (blank lines and
        ``#`` comments ignored).  JSON: either a list of rule strings or
        ``{"seed": N, "rules": [...]}`` (an explicit ``seed`` argument
        wins over the JSON one only if the JSON omits it).
        """
        spec = spec.strip()
        if spec.startswith("{") or spec.startswith("["):
            data = json.loads(spec)
            if isinstance(data, dict):
                return cls(data.get("rules", ()),
                           seed=data.get("seed", seed))
            return cls(data, seed=seed)
        rules = []
        for chunk in spec.replace(";", "\n").splitlines():
            chunk = chunk.strip()
            if chunk and not chunk.startswith("#"):
                rules.append(chunk)
        return cls(rules, seed=seed)

    def decide(self, site: str, ctx: Dict) -> Optional[Action]:
        """First rule that matches *and* fires wins.  A rule's counters
        advance only on events it is CONSULTED for: rules listed after a
        firing rule never see that event (their ``seen`` skips it), while
        rules that match but decline to fire do count it.  Same-site
        multi-rule schedules should order rules with this in mind."""
        with self._lock:
            for rule in self.rules:
                if not rule.matches(site, ctx):
                    continue
                rule.seen += 1
                if not rule.should_fire():
                    continue
                rule.count_fired += 1
                act = Action(rule.action, rule.action_arg, site,
                             rule=rule.text)
                self.fired.append((site, act.kind, dict(ctx)))
                return act
        return None

    def fired_at(self, site: str) -> List[Tuple[str, str, Dict]]:
        with self._lock:
            return [f for f in self.fired if f[0] == site]

    def stats(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [{"text": r.text, "seen": r.seen,
                           "fired": r.count_fired} for r in self.rules],
                "injections": len(self.fired),
            }
