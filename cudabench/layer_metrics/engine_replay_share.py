"""Update engine: the share of engine steps that replayed a captured graph, replays
over replays plus eager fallbacks, from ``engine_report()`` counters gained over the
traced window."""


def read(tr):
    replays = tr.engine.get("replays", 0)
    fallbacks = tr.engine.get("eager_fallbacks", 0)
    if replays + fallbacks == 0:
        return None
    return 100.0 * replays / (replays + fallbacks)
