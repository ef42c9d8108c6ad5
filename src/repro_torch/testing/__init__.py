"""Test doubles the port's tests inject (``fake_engine.FakeEngine``)."""
