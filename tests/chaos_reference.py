"""The JAX package's deterministic chaos campaign at seed 0, pinned.

Written by ``python3 tests/chaos_pin.py`` from ``mirbft_tpu.chaos``'s
``run_campaign(matrix(), seed=0)`` and ``run_campaign(adversary_matrix(),
seed=0)``; held against fresh runs by ``tests/test_torch_chaos.py`` (the
smoke rows in tier 1, every row in the slow lane) and against the port's
campaign on the card by ``chip_smoke.py`` phase 20.

Each row: ``(passed, events, sim_ms, commits, the violation's first
words)``.  Two rows are the reference's own failures: ``ack-loss-70pct``
(recovery past its bound) and ``crash-staggered-pair`` (no commit after
the last heal); ROADMAP queue 3 classifies them.
"""

MATRIX = {
    'baseline': (True, 252, 4870, 80, ''),
    'jitter-30ms': (True, 1141, 4930, 80, ''),
    'jitter-1000ms': (True, 1743, 10919, 80, ''),
    'duplicate-75pct': (True, 1187, 4870, 80, ''),
    'drop-10pct': (True, 1737, 31370, 80, ''),
    'ack-loss-70pct': (False, 6983, 156870, 80, 'recovery took 156870ms of simulated time'),
    'partition-minority': (True, 919, 19770, 80, ''),
    'partition-split-2-2': (True, 396, 12870, 80, ''),
    'partition-flapping': (True, 867, 18570, 80, ''),
    'crash-restart': (True, 862, 15260, 80, ''),
    'crash-staggered-pair': (False, 774, 17000, 80, 'no commits at all after the'),
    'device-digest-dies': (True, 252, 4870, 80, ''),
    'device-digest-short-read': (True, 252, 4870, 80, ''),
    'device-digest-hangs': (True, 252, 4870, 80, ''),
    'partition-plus-crash': (True, 946, 18760, 80, ''),
    'partition-plus-duplication': (True, 1000, 10870, 80, ''),
    'leader-isolation-epoch-change': (True, 1243, 30980, 80, ''),
    'corrupt-propose-signed': (True, 238, 3870, 96, ''),
    'corrupt-digests-in-flight': (True, 814, 12260, 80, ''),
    'corrupt-forwarded-data': (True, 705, 11110, 80, ''),
    'equivocate-majority-suspect': (True, 736, 12870, 80, ''),
    'equivocate-minority-straggler': (True, 513, 8770, 160, ''),
    'censor-client-rotation': (True, 1464, 26370, 80, ''),
    'censor-both-clients': (True, 1590, 27870, 80, ''),
    'flood-stale-acks': (True, 319, 4870, 80, ''),
    'flood-duplicate-proposes': (True, 576, 4870, 80, ''),
    'flood-threephase-storm': (True, 358, 4870, 80, ''),
    'equivocate-plus-flood': (True, 813, 12870, 80, ''),
    'forged-mac-storm': (True, 393, 5710, 80, ''),
    'forged-aggregate-cert': (True, 544, 4670, 160, ''),
    'signed-verifier-dies': (True, 940, 6480, 960, ''),
    'reconfig-add-node': (True, 2578, 28270, 400, ''),
    'reconfig-crash-straddle': (True, 3906, 46340, 400, ''),
    'reconfig-partition-flip': (True, 2642, 32270, 400, ''),
    'reconfig-equivocate-configs': (True, 1241, 23370, 240, ''),
}

ADVERSARY = {
    'corrupt-propose-signed': (True, 314, 3880, 96, ''),
    'corrupt-digests-in-flight': (True, 802, 12260, 80, ''),
    'corrupt-forwarded-data': (True, 401, 6380, 80, ''),
    'equivocate-majority-suspect': (True, 736, 12870, 80, ''),
    'equivocate-minority-straggler': (True, 513, 8770, 160, ''),
    'censor-client-rotation': (True, 1464, 26370, 80, ''),
    'censor-both-clients': (True, 1590, 27870, 80, ''),
    'flood-stale-acks': (True, 340, 4870, 80, ''),
    'flood-duplicate-proposes': (True, 574, 4870, 80, ''),
    'flood-threephase-storm': (True, 351, 4870, 80, ''),
    'equivocate-plus-flood': (True, 806, 12870, 80, ''),
    'forged-mac-storm': (True, 393, 5710, 80, ''),
    'forged-aggregate-cert': (True, 544, 4670, 160, ''),
    'reconfig-equivocate-configs': (True, 1241, 23370, 240, ''),
}

#: Rows where the JAX engine with the port's advance on a late batch digest
#: (ROADMAP queue 3, item 2: a reference fault the port repairs) differs
#: from the JAX engine as it is.  The port is held to these.
LATE_DIGEST = {
    'drop-10pct': (True, 1664, 27920, 80, ''),
}

#: The breaker's walk in the scenarios with a flaky crypto plane: the digest
#: plane's, or the signature plane's in ``signed-verifier-dies``.
BREAKER = {
    'device-digest-dies': {'trips': 1, 'probes': 2, 'state': 'closed', 'errors': 2, 'timeouts': 0},
    'device-digest-short-read': {'trips': 1, 'probes': 2, 'state': 'closed', 'errors': 2, 'timeouts': 0},
    'device-digest-hangs': {'trips': 1, 'probes': 2, 'state': 'closed', 'errors': 0, 'timeouts': 2},
    'signed-verifier-dies': {'trips': 1, 'probes': 1, 'state': 'closed', 'errors': 1, 'timeouts': 0},
}
