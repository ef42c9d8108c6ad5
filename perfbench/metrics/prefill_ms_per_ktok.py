"""Model step, prefill: wall milliseconds of ``InferenceEngine.admit``
(which prefills each admitted prompt with ``transformer.prefill`` and
reads its first token back) per 1000 prompt tokens admitted in the
window, before a traced run's traced part."""


def read(ctx):
    admits = ctx.get("admit") or []
    tokens = sum(sum(lens) for _, lens in admits)
    if ctx.get("kind") != "serve" or not tokens:
        return None
    return sum(w for w, _ in admits) * 1e3 / (tokens / 1e3)
