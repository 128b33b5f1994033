# Argoverse vehicle-only (dynamic branch) layout, 512x512, occ_map 128.
# Mirror of the reference's 512 batch-size family
# (`config/cfg_kitti_baseline_kitti_odom_object_argo_512*.py`): identical
# configs that differ only in IMGS_PER_GPU/workers per GPU count — here a
# single preset with the knobs exposed.
DEPTH_LAYERS = 18
POSE_LAYERS = 18
FRAME_IDS = [0, -1]
IMGS_PER_GPU = 6
HEIGHT = 512
WIDTH = 512

data = dict(
    name="argoverse",
    type="Argo_dynamic",
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
    occ_map_size=128,
    num_class=2,
    loss_type="iou",
    loss_weight=20,
    loss_weightS=20,
    loss2_type="boundary",
    loss2_weight=20,
    loss2_weightS=20,
    loss_sum=3,
    remat=False,
    type="Argo_dynamic",
    split="argo",
    cgt_label_hw=(1028, 1232),
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
