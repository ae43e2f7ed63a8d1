"""The reference's update rules, one module each, found by the traffic's
optimizer name (`train.optimizer`)."""
