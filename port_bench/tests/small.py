"""The CPU tests' small sizes."""

from __future__ import annotations

from port_bench import harness

# A small CSWin-UNet: every kind of stage (stripe widths 1 and 2, a paired
# stage of two blocks, a full-window last stage), 32² slices.
SMALL = dict(img_size=32, in_chans=3, num_classes=9, embed_dim=16, depths=[1, 2, 2, 1],
             num_heads=[2, 2, 4, 8], split_size=[1, 2, 2, 1], mlp_ratio=4.0, qkv_bias=True,
             drop_path_rate=0.2, compute_dtype="bfloat16")


def small_cell(name: str) -> dict:
    """The cell ``name`` with its configuration and traffic cut to a CPU
    test's size, in the configuration's precision; its limits as
    committed."""
    cell = harness.load_cell(name)
    cell["config_data"] = dict(SMALL, compute_dtype=cell["config_data"]["compute_dtype"])
    if cell["traffic_data"]["mode"] == "train":
        cell["traffic_data"].update(batch=4)
        cell["reference_rows"] = 2
    else:
        cell["traffic_data"].update(depth_min=5, depth_max=40, pool=4)
        cell["reference_rows"] = 8
    return cell
