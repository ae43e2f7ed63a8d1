"""Drivers of the window, one module a kind of traffic ("kind" in a traffic file)."""
