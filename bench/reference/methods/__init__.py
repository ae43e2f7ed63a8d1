"""The reference's training methods, one module each, found by the traffic's
method name (`train.method`)."""
