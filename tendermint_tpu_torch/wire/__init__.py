"""Protobuf encoding for sign-bytes."""
