"""apply-crds CLI (reference cmd/apply-crds/main.go:21-23).

A copy of the JAX package's ``cmd/apply_crds.py`` with the same flags;
the port imports nothing of that package. Thin main() over
crdutil.ensure_crds, shipped as a Helm pre-install / pre-upgrade hook Job
so CRDs are installed *and upgraded* despite Helm's install-once CRD
handling (reference pkg/crdutil/README.md:31-57).

Usage:
    python -m k8s_operator_libs_tpu_torch.apply_crds --crds-dir ./crds
        [--crds-dir ./more-crds]
        [--kubeconfig ~/.kube/config | --in-cluster | --dry-run]

Live mode builds a stdlib-HTTP apiextensions client
(core/liveclient.py:LiveCRDClient) from a kubeconfig or the in-cluster
serviceaccount; --dry-run prints what would be applied (useful in CI and
for chart linting).
"""

import argparse
import logging
import sys

from .crdutil import crdutil


def _yaml_error():
    """PyYAML's error class when PyYAML is installed (a YAML kubeconfig
    is read with it), else one that is never raised."""
    try:
        import yaml
    except ImportError:
        return RuntimeError
    return yaml.YAMLError


class _DryRunClient:
    def __init__(self):
        self.applied = []

    def get_crd(self, name):
        raise KeyError(name)

    def create_crd(self, crd):
        self.applied.append(crd["metadata"]["name"])
        print(f"would create CRD {crd['metadata']['name']}")
        return crd

    def update_crd(self, crd):  # pragma: no cover - get always raises
        return crd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--crds-dir", action="append", default=[],
                        help="directory containing CRD YAMLs (repeatable)")
    parser.add_argument("--dry-run", action="store_true",
                        help="print what would be applied, touch nothing")
    parser.add_argument("--kubeconfig", default=None,
                        help="kubeconfig path (default: $KUBECONFIG or "
                             "~/.kube/config)")
    parser.add_argument("--context", default=None,
                        help="kubeconfig context (default: current-context)")
    parser.add_argument("--in-cluster", action="store_true",
                        help="use the pod serviceaccount instead of a "
                             "kubeconfig")
    args = parser.parse_args(argv)
    if not args.crds_dir:
        parser.error("at least one --crds-dir is required")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.dry_run:
        client = _DryRunClient()
    else:
        from .core.liveclient import KubeConfig, KubeHTTP, LiveCRDClient
        try:
            kc = (KubeConfig.in_cluster() if args.in_cluster else
                  KubeConfig.from_kubeconfig(args.kubeconfig, args.context))
        except (OSError, KeyError, RuntimeError, _yaml_error()) as exc:
            print(f"error: cannot load cluster config: {exc}",
                  file=sys.stderr)
            return 2
        client = LiveCRDClient(KubeHTTP(kc))
    try:
        n = crdutil.ensure_crds(client, args.crds_dir)
    except crdutil.EnsureCRDsError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(f"applied {n} CRDs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
