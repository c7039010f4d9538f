"""Mean host time from calling the solve to its return, before the
synchronize, over the window's untraced calls (the harness's own spans)."""


def read(run):
    if not run.issue_s:
        return None
    return 1e3 * sum(run.issue_s) / len(run.issue_s)
