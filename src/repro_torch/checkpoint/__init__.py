"""Checkpoint store and its Rateless IBLT repair — port of
``repro.checkpoint``."""
from .manager import CheckpointStore
from .reconcile import PeerEndpoint, SyncReport, sync_from_peer

__all__ = ["CheckpointStore", "PeerEndpoint", "SyncReport", "sync_from_peer"]
