"""The program's own counters: the totals of the run's process that
`pocketsphinx_tpu_torch.profile.counters` keeps (the set-up's warm call
and the window; the check's frozen copy counts nothing)."""


def program_counters():
    """A copy of the program's counters, or None where the program keeps
    none."""
    try:
        from pocketsphinx_tpu_torch.profile import counters
    except ImportError:
        return None
    return counters()
