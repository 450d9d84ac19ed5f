"""Erasure-code plugin registry.

The reference loads plugins with dlopen and a version handshake
(ErasureCodePluginRegistry, src/erasure-code/ErasureCodePlugin.cc:126-184) and
preloads `osd_erasure_code_plugins` at daemon start (global_init.cc:558).  Here
plugins are Python classes registered by name; ``factory`` validates the profile
the same way the reference's factory() re-checks the returned profile
(ErasureCodePlugin.cc:92-120).  Thread-safe like the reference's singleton.

The torch device a codec's ``cuda`` runtime runs on is an argument of
``factory``, not a profile key: a profile carries only the keys the
plugin parses.
"""

from __future__ import annotations

import threading

from .interface import ErasureCodeInterface, ErasureCodeProfile


class ErasureCodePlugin:
    """Plugin shim: knows how to construct a codec for a profile."""

    def __init__(self, name: str, codec_factory):
        self.name = name
        self._codec_factory = codec_factory

    def factory(self, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        codec = self._codec_factory(profile)
        codec.device = device
        codec.init(profile)
        return codec


class ErasureCodePluginRegistry:
    """Singleton name -> plugin map (ErasureCodePlugin.h:45-79)."""

    _instance: "ErasureCodePluginRegistry | None" = None
    # analysis: allow[bare-lock] -- plugin registry singleton guard; startup only
    _instance_lock = threading.Lock()

    def __init__(self):
        # analysis: allow[bare-lock] -- plugin instance-cache leaf lock
        self._lock = threading.Lock()
        self._plugins: dict[str, ErasureCodePlugin] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise ValueError(f"plugin {name!r} already registered")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self._lock:
            return self._plugins.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._plugins)

    def factory(self, name: str, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        """Build + init a codec whose ``cuda`` runtime runs on ``device``
        (the card by default); KeyError for unknown plugins (the reference
        returns -ENOENT after a failed dlopen)."""
        plugin = self.get(name)
        if plugin is None:
            raise KeyError(
                f"erasure-code plugin {name!r} not found; "
                f"known: {self.names()}")
        return plugin.factory(profile, device)


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()


def register(name: str, codec_factory) -> None:
    """Module-level convenience used by plugin modules at import time (the
    analog of __erasure_code_init)."""
    instance().add(name, ErasureCodePlugin(name, codec_factory))
