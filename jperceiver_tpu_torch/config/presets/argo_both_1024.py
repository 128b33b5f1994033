# Argoverse dual-branch (road + vehicle) layout, 1024x1024.
# Mirror of `config/cfg_kitti_baseline_argo_both_boundary_ce_iou_1024_20_B1.py`.
DEPTH_LAYERS = 18
POSE_LAYERS = 18
FRAME_IDS = [0, -1, 1]
IMGS_PER_GPU = 3
HEIGHT = 1024
WIDTH = 1024

data = dict(
    name="argoverse",
    type="Argo_both",
    split="argo",
    split_dir=None,          # None: the packaged lists, data/artifacts/splits
    height=HEIGHT,
    width=WIDTH,
    frame_ids=FRAME_IDS,
    in_path="/data/argoverse",
    raw_calib_root="/data/kitti/raw",   # for velodyne GT depth at eval
    png=True,
)

model = dict(
    name="JPerceiver",
    depth_num_layers=DEPTH_LAYERS,
    pose_num_layers=POSE_LAYERS,
    frame_ids=FRAME_IDS,
    imgs_per_gpu=IMGS_PER_GPU,
    height=HEIGHT,
    width=WIDTH,
    scales=[0, 1, 2, 3],
    min_depth=0.1,
    max_depth=100.0,
    automask=True,
    disp_norm=True,
    smoothness_weight=1e-3,
    scale_weight=0.1,
    dynamic_weight=15.0,
    static_weight=5.0,
    occ_map_size=256,
    num_class=2,
    loss_type="iou",
    loss_weight=20,
    loss_weightS=20,
    loss2_type="boundary",
    loss2_weight=20,
    loss2_weightS=20,
    loss_sum=3,
    # Gradient checkpointing of the encoder and decoder trunks (the JAX
    # package sets it because B=3 at 1024^2 does not fit its 16 GB TPU chips).
    remat=True,
    type="Argo_both",
    split="argo",
    cgt_label_hw=(2056, 2464),
)

resume_from = None
finetune = None
load_from = None
total_epochs = 180
imgs_per_gpu = IMGS_PER_GPU
learning_rate = 1e-4
workers_per_gpu = 8
validate = True

optimizer = dict(type="Adam", lr=learning_rate, weight_decay=0)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(policy="step", warmup=None, step=[50])
checkpoint_config = dict(interval=1)
log_config = dict(interval=50)
