"""The harness's parts: the cell's files (`spec`), the inputs and units
(`drive`), the tracing (`trace`, `bounds`), the check (`check`) and one
run (`harness`)."""
