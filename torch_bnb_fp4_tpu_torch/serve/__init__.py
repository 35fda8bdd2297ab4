"""Greedy continuous-batching engine."""

from .engine import Completion, Engine, EngineConfig, Request

__all__ = ["Completion", "Engine", "EngineConfig", "Request"]
