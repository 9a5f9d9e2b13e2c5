"""Per-node container-image/layer cache and registry pull model.

Shabari's testbed (and the depsched simulator it cites) treat a cold
start as *pull what's missing*: a container image is an ordered stack of
content-addressed layers, nodes keep a finite local layer store, and the
registry only ships the layers the node doesn't already hold.  This
module provides the vocabulary:

- ``ImageSpec``     — an immutable ordered layer stack (digest, MB).
  Clone aliases (``fn::k``) of the same base function share everything
  but a tiny per-alias config layer, and *all* functions share the
  OS/runtime base layers — exactly how real registries dedupe.
- ``NodeImageCache`` — one per worker: finite store bytes, LRU eviction
  that never evicts pinned or in-use layers, and hit/miss/evict
  counters.  ``pull()`` charges only the missing bytes over the node's
  registry bandwidth (same ``MB * 8 / 1000 / gbps`` wire math as
  ``fleet.Link``).
- ``ImageCacheSpec`` — the ``SimConfig(image_cache=...)`` knob.  The
  ``None`` default keeps the flat-constant cold model and costs nothing.

The simulator overlaps the pull with the flat ``cold_base_s`` unpack
cost: effective cold latency = max(classic cold curve, residual pull).
A fully-resident image therefore reproduces the flat baseline exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Mapping, Optional, Tuple

# Universal layers every image stacks on: a distro base and a language
# runtime.  Shared across *all* functions, so one pull warms the fleet.
OS_BASE_LAYER = ("base/os", 120.0)
RUNTIME_LAYER = ("base/runtime", 240.0)
BASE_LAYERS: Tuple[Tuple[str, float], ...] = (OS_BASE_LAYER, RUNTIME_LAYER)

# MB on the wire -> seconds at 1 Gbps (mirrors fleet.Link.transfer_s).
_S_PER_MB_PER_GBPS = 8.0 / 1000.0


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    """An ordered stack of (digest, size_mb) layers, base-first."""

    name: str
    layers: Tuple[Tuple[str, float], ...]

    @property
    def total_mb(self) -> float:
        return sum(mb for _, mb in self.layers)

    @property
    def digests(self) -> Tuple[str, ...]:
        return tuple(d for d, _ in self.layers)


def _base_function(fn: str) -> str:
    # Local strip of the ``::k`` clone-alias suffix (mirrors
    # repro_torch.serving.profiles.base_function without a core->serving import).
    return fn.split("::", 1)[0]


def _app_layers(base_fn: str) -> Tuple[Tuple[str, float], ...]:
    """Deterministic per-base-function app layers: two dependency layers
    plus a small code layer, sizes hashed from the function name."""
    h = int.from_bytes(
        hashlib.md5(base_fn.encode()).digest()[:8], "big")
    deps0 = 100.0 + (h % 400)            # 100-499 MB
    deps1 = 50.0 + ((h >> 16) % 250)     # 50-299 MB
    code = 5.0 + ((h >> 32) % 45)        # 5-49 MB
    return (
        (f"app/{base_fn}/deps0", deps0),
        (f"app/{base_fn}/deps1", deps1),
        (f"app/{base_fn}/code", code),
    )


# Per-alias config layer: tiny, so siblings of a pulled clone miss
# almost nothing.
ALIAS_LAYER_MB = 2.0


def default_images(functions) -> Dict[str, ImageSpec]:
    """Build the default image catalog for a set of function names.

    Clone aliases (``fn::k``) share every layer of their base function's
    image except a 2 MB per-alias config layer; all images share the
    OS/runtime base layers.
    """
    out: Dict[str, ImageSpec] = {}
    for fn in functions:
        bf = _base_function(fn)
        layers = BASE_LAYERS + _app_layers(bf)
        if fn != bf:
            layers = layers + ((f"alias/{fn}", ALIAS_LAYER_MB),)
        out[fn] = ImageSpec(name=fn, layers=layers)
    return out


@dataclasses.dataclass(frozen=True)
class ImageCacheSpec:
    """``SimConfig(image_cache=...)`` knob.

    - ``images``: explicit function -> ImageSpec assignments as a tuple
      of pairs (hashable).  ``None`` falls back to the fleet's
      ``FleetSpec.images`` assignments, then to ``default_images()``
      over the run's function population.
    - ``affinity``: when True the scheduler ranks cold placements by
      residual pull seconds and the router prices each candidate's
      residual pull; when False the cache still charges pulls but every
      decision stays cache-blind (the A/B arm).
    - ``pin_base``: pin the shared OS/runtime base layers so LRU churn
      never evicts them.
    """

    images: Optional[Tuple[Tuple[str, ImageSpec], ...]] = None
    affinity: bool = True
    pin_base: bool = True


class NodeImageCache:
    """One worker's layer store: finite bytes, LRU eviction (pinned and
    in-use layers exempt), and a registry link for pull pricing."""

    __slots__ = ("store_mb", "registry_gbps", "used_mb", "hits", "misses",
                 "evictions", "_layers", "_pinned", "_inuse_images",
                 "_tick")

    def __init__(self, store_mb: float, registry_gbps: float = 10.0,
                 pinned: Tuple[str, ...] = ()):
        self.store_mb = float(store_mb)
        self.registry_gbps = float(registry_gbps)
        self.used_mb = 0.0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # digest -> [size_mb, last_used_tick, in_use_count]
        self._layers: Dict[str, List] = {}
        self._pinned = set(pinned)
        # image name -> [ImageSpec, container_count]
        self._inuse_images: Dict[str, List] = {}
        self._tick = 0

    # ------------------------------------------------------------ probes
    def resident(self, digest: str) -> bool:
        return digest in self._layers

    def missing_mb(self, image: ImageSpec) -> float:
        """Bytes the registry would have to ship for this image now.
        Read-only: safe for scheduler/router candidate probes."""
        layers = self._layers
        return sum(mb for d, mb in image.layers if d not in layers)

    def residual_pull_s(self, image: ImageSpec) -> float:
        """Seconds to pull the missing layers over the registry link."""
        gbps = self.registry_gbps
        if gbps == float("inf"):
            return 0.0
        return self.missing_mb(image) * _S_PER_MB_PER_GBPS / gbps

    def full_pull_s(self, image: ImageSpec) -> float:
        """Seconds a from-scratch pull of the whole image would take —
        the scale of the locality benefit this node could ever offer."""
        gbps = self.registry_gbps
        if gbps == float("inf"):
            return 0.0
        return image.total_mb * _S_PER_MB_PER_GBPS / gbps

    # ----------------------------------------------------------- actions
    def pull(self, image: ImageSpec) -> float:
        """Materialise ``image`` on this node and return the pull time in
        seconds (0.0 on a full cache hit).  Missing layers are fetched,
        LRU-evicting unpinned idle layers to make room; every layer of
        the image is then marked in-use until ``release()``."""
        self._tick += 1
        tick = self._tick
        layers = self._layers
        need: List[Tuple[str, float]] = []
        for d, mb in image.layers:
            ent = layers.get(d)
            if ent is not None:
                self.hits += 1
                ent[1] = tick
            else:
                self.misses += 1
                need.append((d, mb))
        missing_mb = 0.0
        if need:
            missing_mb = sum(mb for _, mb in need)
            # the in-flight image's own layers are off-limits: a hit
            # above isn't refcounted until the loop below, and evicting
            # it here would un-materialise the image mid-pull
            self._evict_for(missing_mb, protect=image.digests)
            for d, mb in need:
                layers[d] = [mb, tick, 0]
                self.used_mb += mb
        # refcount: the new container holds every layer of its image
        for d, _ in image.layers:
            layers[d][2] += 1
        ref = self._inuse_images.get(image.name)
        if ref is None:
            self._inuse_images[image.name] = [image, 1]
        else:
            ref[1] += 1
        gbps = self.registry_gbps
        if missing_mb == 0.0 or gbps == float("inf"):
            return 0.0
        return missing_mb * _S_PER_MB_PER_GBPS / gbps

    def release(self, function: str) -> None:
        """Drop one container's reference to ``function``'s image (called
        when the container is reaped); layers become evictable once no
        container references them."""
        ref = self._inuse_images.get(function)
        if ref is None:
            return
        image, count = ref[0], ref[1]
        layers = self._layers
        for d, _ in image.layers:
            ent = layers.get(d)
            if ent is not None and ent[2] > 0:
                ent[2] -= 1
        if count <= 1:
            del self._inuse_images[function]
        else:
            ref[1] = count - 1

    def pin(self, digests) -> None:
        self._pinned.update(digests)

    def _evict_for(self, incoming_mb: float,
                   protect: Tuple[str, ...] = ()) -> None:
        """LRU-evict idle unpinned layers until ``incoming_mb`` fits.
        If pinned/in-use/protected layers make that impossible the store
        is allowed to overflow — a pull in flight can't be refused."""
        if self.used_mb + incoming_mb <= self.store_mb:
            return
        keep = self._pinned.union(protect) if protect else self._pinned
        victims = sorted(
            ((ent[1], d) for d, ent in self._layers.items()
             if ent[2] == 0 and d not in keep))
        for _, d in victims:
            if self.used_mb + incoming_mb <= self.store_mb:
                break
            self.used_mb -= self._layers.pop(d)[0]
            self.evictions += 1
