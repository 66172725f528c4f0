"""dispatch_ms.granite: Host wall ms per Granite 4.0-H mixer core inside the
outermost evaluator ops (the port's ``op.*`` spans), device waits included:
the host's time issuing the ops, and the time an op waits on the card (a
pageable copy of a constant, a decrypt's copy to the host). Not pure
dispatch: a change that removes a wait on the card moves it too."""

from fhe_bench import recorded


def read(run):
    return recorded.host_ms_per_request(run, "op.")
