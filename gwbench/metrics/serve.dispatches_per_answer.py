"""Segments the engine dispatched an answer: the program's counter
`GWEngine.stats` ``dispatches`` over the window's answers."""


def read(ctx):
    stats = ctx.window.get("stats") or {}
    answers = ctx.window.get("answers", 0)
    if ctx.kind != "serve" or not answers or "dispatches" not in stats:
        return None
    return stats["dispatches"] / answers
