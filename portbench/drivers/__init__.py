"""One module per entry of the program that a configuration drives,
named by the configuration's `driver`. Each gives `block_samples(config)`,
`frequencies(config, traffic)` (where the capture's carriers may sit),
`reference(config, traffic, raws, arith)` and `numbers(ours, ref)`, and a
`System` built from (config, traffic, ring, device) with `loop(hooks)`,
`copy(outputs)`, `launches()`, `ranges` and `close()`."""


def kernel_launches() -> dict:
    """K1's launches by form and K1-TC's, as the program counts them."""
    from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate
    from sdrangel_tpu_torch.kernels.flat_decimate_tc import flat_decimate_tc

    return {"K1": flat_decimate.launches,
            **{f"K1 {k}": v for k, v in flat_decimate.form_launches.items()},
            "K1-TC": flat_decimate_tc.launches}
