"""``topn_users_per_s``: users ranked in the window's calls over the
seconds of those calls, on the host's clock (a call returns its answers
on the host, so it has ended on the card)."""


def read(run):
    calls = run.cell.calls
    if not calls:
        return None
    return sum(c.users for c in calls) / sum(c.wall_s for c in calls)
