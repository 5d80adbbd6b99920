"""Operations and bytes of each kernel and model, from shapes alone: the
yardstick of the roofline and MFU metrics. One module per kernel or model,
found by name."""
