"""Resilience primitives of the distributed plane; only the seeded retry
backoff the rollout service uses is ported (the rest: ROADMAP queue 1 item
9)."""
