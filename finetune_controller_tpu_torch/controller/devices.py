"""Device catalog — flavors, quotas, and the submission-form enum.

The port's catalog names the NVIDIA H100 card (flavor ``h100``: one chip,
``runtime="cuda"``, requested as ``nvidia.com/gpu``, the upstream
reference's own GPU model) in place of the JAX package's TPU slices, and
keeps the ``cpu-test`` flavor whose jobs train on the host (``--device
cpu``).  The port trains on one device: :func:`default_mesh_for` checks a
spec's mesh policy against the flavor's chips as the reference does,
renders the one-device mesh and refuses anything wider (ROADMAP Queue A
item 7).

What follows is the reference's description of the catalog it copies.

Capability parity with the reference's worker/device configuration
(``app/core/device_config.py:16-109`` + ``example.config.json`` — SURVEY.md §2
component 12), redesigned for TPU pod-slice granularity:

- the reference's flat GPU count (``accelerators: {"nvidia.com/gpu": n}``,
  ``example.config.json:20-23``) becomes a **slice flavor**: chip generation,
  topology (e.g. ``4x4``), hosts × chips/host — because TPUs are provisioned as
  whole slices, not per-chip (SURVEY.md §7 "hard parts": slice topology ↔
  scheduler quota);
- each flavor carries its scheduler queue name + nominal chip quota (the
  Kueue ClusterQueue / ResourceFlavor data, ``crds/kueue/cluster-queue.yaml:13-22``)
  so the in-repo gang scheduler can enforce admission the way Kueue does;
- JSON config files may contain ``//`` comments, as the reference allows
  (``device_config.py:81-85``);
- a missing config file degrades to the built-in default catalog with a log
  line, mirroring the reference's empty-catalog fallback (``device_config.py:96-101``).
"""

from __future__ import annotations

import enum
import json
import logging
import math
import re
from pathlib import Path

from pydantic import BaseModel, Field

logger = logging.getLogger(__name__)


class DeviceFlavor(BaseModel):
    """One schedulable slice shape (reference: ``Worker``, ``device_config.py:16-44``)."""

    name: str  # e.g. "h100"
    description: str = ""
    generation: str = "h100"  # h100 | cpu
    topology: str = ""  # e.g. "4x4" (empty for cpu flavors)
    hosts: int = 1
    chips_per_host: int = 4
    #: scheduler LocalQueue this flavor feeds (reference: ``LocalQueue``,
    #: ``example.config.json:18``)
    queue: str = "default-queue"
    #: host-side pod resources (reference: default resources, ``example.config.json:8-14``)
    cpu: str = "8"
    memory: str = "32Gi"
    #: node-selector labels for K8s backends (replaces GPU tolerations,
    #: reference ``example.config.json:24-31``)
    node_selectors: dict[str, str] = Field(default_factory=dict)
    #: "cuda" runs on the card; "cpu" runs the trainer on the host (the
    #: CI/smoke runtime the reference never had — SURVEY.md §4)
    runtime: str = "cuda"

    @property
    def total_chips(self) -> int:
        return self.hosts * self.chips_per_host

    def k8s_resource_name(self) -> str:
        """The extended-resource key requested on pods (``nvidia.com/gpu``,
        reference ``PyTorchJobDeployer.py:45-55``)."""
        return "cpu" if self.runtime == "cpu" else "nvidia.com/gpu"

    def accelerator_selectors(self) -> dict[str, str]:
        """GPU node selectors: the flavor's own labels (a GPU is requested
        by count, so there is no topology selector)."""
        if self.runtime == "cpu":
            return {}
        return dict(self.node_selectors)


class FlavorQuota(BaseModel):
    """Nominal chip quota for one flavor in the cluster queue (reference:
    ``nominalQuota``, ``crds/kueue/cluster-queue.yaml:18-22``)."""

    flavor: str
    nominal_chips: int


class DeviceCatalog(BaseModel):
    """The full worker catalog (reference: ``APIConfiguration``,
    ``device_config.py:46-75``)."""

    flavors: list[DeviceFlavor] = Field(default_factory=list)
    quotas: list[FlavorQuota] = Field(default_factory=list)
    default_flavor: str = ""

    def get(self, name: str) -> DeviceFlavor | None:
        for f in self.flavors:
            if f.name == name:
                return f
        return None

    def get_worker(self, name: str) -> DeviceFlavor:
        """Resolve a flavor, falling back to the default (reference:
        ``device_configuration.get_worker`` + default-queue fallback,
        ``device_config.py:59-75``)."""
        f = self.get(name)
        if f is not None:
            return f
        if self.default_flavor:
            fallback = self.get(self.default_flavor)
            if fallback is not None:
                logger.warning("unknown device %r; using default %r", name, fallback.name)
                return fallback
        raise KeyError(f"unknown device flavor {name!r} and no default configured")

    def quota_for(self, flavor: str) -> int:
        for q in self.quotas:
            if q.flavor == flavor:
                return q.nominal_chips
        f = self.get(flavor)
        return f.total_chips if f else 0

    def names(self) -> list[str]:
        return [f.name for f in self.flavors]

    def device_enum(self) -> type[enum.Enum]:
        """Dynamic enum for the submission form (reference: ``DeviceTypes``,
        ``device_config.py:107-109``)."""
        return enum.Enum("DeviceTypes", {f.name: f.name for f in self.flavors})


def default_catalog() -> DeviceCatalog:
    """Built-in catalog: the H100 card plus the CPU smoke flavor."""
    return DeviceCatalog(
        flavors=[
            DeviceFlavor(
                name="cpu-test", description="host CPU for CI/smoke",
                generation="cpu", topology="", hosts=1, chips_per_host=1,
                queue="cpu-queue", cpu="2", memory="4Gi", runtime="cpu",
            ),
            DeviceFlavor(
                name="h100", description="one NVIDIA H100 80GB card",
                generation="h100", topology="", hosts=1, chips_per_host=1,
                queue="gpu-queue", cpu="8", memory="96Gi", runtime="cuda",
            ),
        ],
        quotas=[
            FlavorQuota(flavor="cpu-test", nominal_chips=2),
            FlavorQuota(flavor="h100", nominal_chips=1),
        ],
        default_flavor="cpu-test",
    )


_COMMENT_RE = re.compile(r"^\s*//.*$", re.MULTILINE)


def load_catalog(path: Path | str | None) -> DeviceCatalog:
    """Load the catalog from a JSON file with ``//`` comment support
    (reference: ``load_config``, ``device_config.py:81-104``); fall back to
    the built-in default catalog when absent."""
    if not path:
        return default_catalog()
    path = Path(path).expanduser()
    if not path.is_file():
        logger.warning("device config %s not found; using built-in catalog", path)
        return default_catalog()
    text = _COMMENT_RE.sub("", path.read_text())
    return DeviceCatalog.model_validate(json.loads(text))


#: axes a mesh policy may declare (trainer MeshSpec axis names)
_POLICY_AXES = ("fsdp", "ep", "pp", "sp", "tp")


def _resolve(axes: dict[str, int], n_devices: int) -> dict[str, int]:
    """Mesh axis sizes over ``n_devices``, at most one of them ``-1`` (the
    reference's ``MeshSpec.resolve``, ``parallel/mesh.py:56-80``, with its
    messages)."""
    sizes = {a: axes.get(a, 1) for a in ("dp", "fsdp", "ep", "pp", "sp", "tp")}
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
    known = math.prod(v for v in sizes.values() if v != -1)
    if unknown:
        if n_devices % known:
            raise ValueError(
                f"cannot infer {unknown[0]}: {n_devices} devices not divisible "
                f"by product of fixed axes {known}"
            )
        sizes[unknown[0]] = n_devices // known
    elif known != n_devices:
        raise ValueError(f"mesh {sizes} needs {known} devices but {n_devices} are available")
    return sizes


def default_mesh_for(
    flavor: DeviceFlavor,
    num_slices: int = 1,
    policy: dict[str, int] | None = None,
) -> dict[str, int]:
    """Map a slice request to trainer mesh axis sizes: the one-device mesh.

    ``policy`` is the job spec's intra-slice axis declaration (fsdp/ep/pp/
    sp/tp; one value may be ``-1``, "all remaining chips"), validated as the
    reference validates it: a policy the flavor's chips cannot satisfy
    (``{"ep": 8}`` on one card) raises the reference's ``ValueError``.  The
    port trains on one device, so a grant of more than one chip raises
    ``NotImplementedError`` (ROADMAP Queue A item 7, multi-GPU).
    """
    policy = dict(policy) if policy else {"fsdp": -1}
    unknown = set(policy) - set(_POLICY_AXES)
    if unknown:
        raise ValueError(f"mesh policy axes {sorted(unknown)} not in {_POLICY_AXES}")
    for a, v in policy.items():
        if v != -1 and v < 1:
            raise ValueError(f"mesh policy axis {a}={v} must be >= 1 or -1")
    try:
        _resolve({"dp": 1, "fsdp": 1, **policy}, flavor.total_chips)
    except ValueError as exc:
        raise ValueError(
            f"device {flavor.name!r} ({flavor.total_chips} chips) cannot "
            f"satisfy the model's mesh policy {policy}: {exc}"
        ) from None
    chips = flavor.total_chips * max(1, num_slices)
    if chips > 1:
        raise NotImplementedError(
            f"device {flavor.name!r} x {max(1, num_slices)} slice(s) = {chips} "
            "chips: the port trains on one device; multi-card meshes and "
            "resize are not ported yet (ROADMAP Queue A item 7)"
        )
    return {"dp": 1, **{a: 1 for a in _POLICY_AXES}}
