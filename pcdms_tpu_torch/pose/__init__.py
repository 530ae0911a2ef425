from pcdms_tpu_torch.pose.keypoints import (
    read_pose_txt, write_pose_txt, coco_to_openpose,
)
from pcdms_tpu_torch.pose.skeleton import (
    draw_bodypose, draw_handpose, render_pose,
)
