"""Crash-restart explorer: systematic kills at every durable-write site.

The operator's whole restart story rests on one claim: *all* state that
matters survives in the cluster (labels, annotations, taints, leases),
so a process killed at ANY instant reboots and converges. The chaos
harness has long proven recovery from hand-picked failover points; this
package proves it at every durable-write boundary systematically:

- :mod:`.registry` declares every durable-write SITE at the
  provider/client choke points (state label + journey patch, the
  rollout decree, quarantine label/taint, repair bookkeeping, market
  lease stamps, drain/migration intent, replica registration, the
  cordon flip) and the names of the port's ``wire.py`` keys each one
  stamps;
- :mod:`.explorer` runs a pinned scenario once to RECORD which sites
  occur, then sweeps: for each site, immediately BEFORE and immediately
  AFTER a chosen occurrence of the write, the operator is killed
  (:class:`~k8s_operator_libs_tpu_torch.chaos.campaign.OperatorKilled` raised
  at the exact client call) and a FRESH operator + standby resume
  against the surviving cluster state; the run must converge with every
  standing chaos invariant green.

Seeded, replayable, shrinkable: a failing crash point reports its exact
replay command, and the scenario shrinks to the minimal fault set that
still fails under the same crash plan.

``python -m k8s_operator_libs_tpu_torch.chaos.crash`` runs the full
sweep, ``--smoke`` a budgeted subset. The port's twin of the JAX
package's ``tools/crash/`` (its lint pass is not ported); it imports
nothing of that package.
"""
