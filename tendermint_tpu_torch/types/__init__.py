"""Commit, validator set and the commit-verification entry points."""
