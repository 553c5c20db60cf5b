"""Frontend seconds (PCM to features, `decode_corpus(timings=)`'s
"frontend" stage, synced at its end) per audio second, in ms."""


def read(ctx):
    t = ctx.get("timings", {}).get("frontend")
    if t is None or not ctx.get("audio_s"):
        return None
    return t * 1e3 / ctx["audio_s"]
