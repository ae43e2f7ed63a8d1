"""One module a `repro_torch::` operator whose calls a roofline metric reads:
`bound(shapes, dtypes, inputs)` gives the call's (bytes, operations, dtype
of the peak) from its recorded shapes, dtypes and scalar inputs
(`roofline.call_bound_s`)."""
