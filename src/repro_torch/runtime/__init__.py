"""Fault-tolerant execution (crash points, heartbeats, failure
injection, checkpoint/restart recovery), ported from ``repro.runtime``."""
