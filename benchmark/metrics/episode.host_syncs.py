"""episode.host_syncs: host syncs per action over the traced stretch, from the
program's counter (utils/tracing.host_value, summed over every stage)."""


def read(ctx):
    if ctx.host_syncs is None:
        return None
    return ctx.host_syncs / ctx.actions
