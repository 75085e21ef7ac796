"""Sharding rules and partition specs."""
