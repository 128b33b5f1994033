# Argoverse road-only (static branch) layout, 1024x1024.
# Mirror of `config/cfg_kitti_baseline_argo_static_boundary_ce_dice_1024.py`.
DEPTH_LAYERS = 18
POSE_LAYERS = 18
FRAME_IDS = [0, -1]
IMGS_PER_GPU = 3
HEIGHT = 1024
WIDTH = 1024

data = dict(
    name="argoverse",
    type="Argo_static",
    split="argo",
    split_dir=None,          # point at a splits directory
    height=HEIGHT,
    width=WIDTH,
    frame_ids=FRAME_IDS,
    in_path="/data/argoverse",
    png=True,
)

model = dict(
    name="JPerceiver",
    depth_num_layers=DEPTH_LAYERS,
    pose_num_layers=POSE_LAYERS,
    # ImageNet trunk init (reference `depth_pretrained_path` /
    # `pose_pretrained_path`); set to local resnet .pth files to enable.
    depth_pretrained_path=None,
    pose_pretrained_path=None,
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
    seg_class="car",
    dynamic_weight=15.0,
    static_weight=5.0,
    occ_map_size=256,
    num_class=2,
    loss_type="dice",
    loss_weight=10,
    loss_weightS=10,
    loss2_type="boundary",
    loss2_weight=10,
    loss2_weightS=10,
    loss_sum=3,
    remat=False,
    type="Argo_static",
    split="argo",
    cgt_label_hw=(2056, 2464),
)

resume_from = None
finetune = None
load_from = None
total_epochs = 120
imgs_per_gpu = IMGS_PER_GPU
learning_rate = 1e-4
workers_per_gpu = 8
validate = True

optimizer = dict(type="Adam", lr=learning_rate, weight_decay=0)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(policy="step", warmup=None, step=[50])
checkpoint_config = dict(interval=1)
log_config = dict(interval=50)
