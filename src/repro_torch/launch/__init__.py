"""Launch: process groups and meshes, step builders, the dry run and its
cost analysis and roofline."""
