"""COLMAP sparse reconstruction -> MVSNet-format scene converter; a copy of
damvsnet_tpu/cli/colmap2mvsnet.py (numpy; an image that is not a JPEG is
re-encoded by cv2, imported where it runs).

Capability parity with the reference's colmap2mvsnet.py: per-camera-model
intrinsics extraction, robust depth ranges from the sparse points (mean of
bottom 3% / top 10% view-frame depths), inverse-depth-derived hypothesis
count (max_d=0), pairwise view-selection score
sum_p exp(-(theta - theta0)^2 / (2 sigma^2)) over shared 3D points
(sigma1 below theta0, sigma2 above), and cams/pair.txt/images_post output.

Implementation is vectorized numpy (the reference loops per point with a
multiprocessing pool); scores are numerically identical.
"""
from __future__ import annotations

import argparse
import collections
import os
import shutil
import struct

import numpy as np

Camera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
Image = collections.namedtuple("Image", ["id", "qvec", "tvec", "camera_id",
                                         "name", "xys", "point3D_ids"])
Point3D = collections.namedtuple("Point3D", ["id", "xyz", "rgb", "error",
                                             "image_ids", "point2D_idxs"])

PARAM_TYPE = {
    "SIMPLE_PINHOLE": ["f", "cx", "cy"],
    "PINHOLE": ["fx", "fy", "cx", "cy"],
    "SIMPLE_RADIAL": ["f", "cx", "cy", "k"],
    "SIMPLE_RADIAL_FISHEYE": ["f", "cx", "cy", "k"],
    "RADIAL": ["f", "cx", "cy", "k1", "k2"],
    "RADIAL_FISHEYE": ["f", "cx", "cy", "k1", "k2"],
    "OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"],
    "OPENCV_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"],
    "FULL_OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3",
                    "k4", "k5", "k6"],
    "FOV": ["fx", "fy", "cx", "cy", "omega"],
    "THIN_PRISM_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                           "k3", "k4", "sx1", "sy1"],
}

_CAMERA_MODEL_IDS = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE",
}
_NUM_PARAMS = {
    "SIMPLE_PINHOLE": 3, "PINHOLE": 4, "SIMPLE_RADIAL": 4, "RADIAL": 5,
    "OPENCV": 8, "OPENCV_FISHEYE": 8, "FULL_OPENCV": 12, "FOV": 5,
    "SIMPLE_RADIAL_FISHEYE": 4, "RADIAL_FISHEYE": 5, "THIN_PRISM_FISHEYE": 12,
}


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y ** 2 - 2 * z ** 2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x ** 2 - 2 * z ** 2, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x ** 2 - 2 * y ** 2],
    ])


# ------------------------------ model readers ------------------------------


def _read_cameras_txt(path):
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cameras[int(el[0])] = Camera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return cameras


def _read_images_txt(path):
    images = {}
    with open(path) as f:
        lines = [line.strip() for line in f
                 if line.strip() and not line.startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        image_id = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        pts = lines[i + 1].split()
        xys = np.array([[float(pts[j]), float(pts[j + 1])]
                        for j in range(0, len(pts), 3)]) if pts else np.zeros((0, 2))
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)],
                       dtype=np.int64) if pts else np.zeros(0, np.int64)
        images[image_id] = Image(image_id, qvec, tvec, int(el[8]), el[9], xys, ids)
    return images


def _read_points3d_txt(path):
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            points[pid] = Point3D(
                pid, np.array([float(x) for x in el[1:4]]),
                np.array([int(x) for x in el[4:7]]), float(el[7]),
                np.array([int(x) for x in el[8::2]]),
                np.array([int(x) for x in el[9::2]]))
    return points


def _read_next_bytes(f, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, f.read(num_bytes))


def _read_cameras_bin(path):
    cameras = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            cid, model_id, width, height = _read_next_bytes(f, 24, "iiQQ")
            model = _CAMERA_MODEL_IDS[model_id]
            n = _NUM_PARAMS[model]
            params = np.array(_read_next_bytes(f, 8 * n, "d" * n))
            cameras[cid] = Camera(cid, model, width, height, params)
    return cameras


def _read_images_bin(path):
    images = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            props = _read_next_bytes(f, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n2d = _read_next_bytes(f, 8, "Q")[0]
            data = _read_next_bytes(f, 24 * n2d, "ddq" * n2d)
            xys = np.array(data).reshape(-1, 3)[:, :2] if n2d else np.zeros((0, 2))
            ids = np.array(data[2::3], dtype=np.int64) if n2d else np.zeros(0, np.int64)
            images[image_id] = Image(image_id, qvec, tvec, camera_id,
                                     name.decode(), xys, ids)
    return images


def _read_points3d_bin(path):
    points = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            props = _read_next_bytes(f, 43, "QdddBBBd")
            pid = props[0]
            xyz = np.array(props[1:4])
            rgb = np.array(props[4:7])
            error = props[7]
            track_len = _read_next_bytes(f, 8, "Q")[0]
            track = _read_next_bytes(f, 8 * track_len, "ii" * track_len)
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  np.array(track[0::2]), np.array(track[1::2]))
    return points


def read_model(model_dir, ext=".bin"):
    if ext == ".txt":
        return (_read_cameras_txt(os.path.join(model_dir, "cameras.txt")),
                _read_images_txt(os.path.join(model_dir, "images.txt")),
                _read_points3d_txt(os.path.join(model_dir, "points3D.txt")))
    return (_read_cameras_bin(os.path.join(model_dir, "cameras.bin")),
            _read_images_bin(os.path.join(model_dir, "images.bin")),
            _read_points3d_bin(os.path.join(model_dir, "points3D.bin")))


# ------------------------------ conversion ------------------------------


def convert_scene(dense_folder, save_folder, max_d=192, interval_scale=1.0,
                  theta0=5.0, sigma1=1.0, sigma2=10.0, model_ext=".bin",
                  num_src_views=10, log_fn=print):
    image_dir = os.path.join(dense_folder, "images")
    model_dir = os.path.join(dense_folder, "sparse")
    cam_dir = os.path.join(save_folder, "cams")
    image_out_dir = os.path.join(save_folder, "images_post")
    os.makedirs(save_folder, exist_ok=True)
    for d in (cam_dir, image_out_dir):
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d)

    cameras, images, points3d = read_model(model_dir, model_ext)
    # renumber 1..N in sorted-id order (parity with the reference)
    images = {i + 1: images[k] for i, k in enumerate(sorted(images))}
    num_images = len(images)

    intrinsic = {}
    for cid, cam in cameras.items():
        pd = dict(zip(PARAM_TYPE[cam.model], cam.params))
        if "f" in PARAM_TYPE[cam.model]:
            pd["fx"] = pd["fy"] = pd["f"]
        intrinsic[cid] = np.array([[pd["fx"], 0, pd["cx"]],
                                   [0, pd["fy"], pd["cy"]], [0, 0, 1]])

    extrinsic = {}
    for iid, im in images.items():
        e = np.eye(4)
        e[:3, :3] = qvec2rotmat(im.qvec)
        e[:3, 3] = im.tvec
        extrinsic[iid] = e

    # depth ranges (robust percentile means) + hypothesis count
    depth_ranges = {}
    for i in range(num_images):
        im = images[i + 1]
        valid = im.point3D_ids != -1
        pids = im.point3D_ids[valid]
        if len(pids) == 0:
            depth_ranges[i + 1] = (0.1, 0.01, max_d or 192, 2.0)
            continue
        xyz = np.stack([points3d[p].xyz for p in pids])
        z = (extrinsic[i + 1][:3, :3] @ xyz.T + extrinsic[i + 1][:3, 3:4])[2]
        zs = np.sort(z)
        num_max = max(5, int(len(zs) * 0.1))
        num_min = max(1, int(len(zs) * 0.03))
        depth_min = float(zs[:num_min].mean())
        depth_max = float(zs[-num_max:].mean())
        if max_d == 0:
            k = intrinsic[im.camera_id]
            r = extrinsic[i + 1][:3, :3]
            t = extrinsic[i + 1][:3, 3]
            p1 = np.array([k[0, 2], k[1, 2], 1.0])
            p2 = np.array([k[0, 2] + 1, k[1, 2], 1.0])
            pw1 = np.linalg.inv(r) @ (np.linalg.inv(k) @ p1 * depth_min - t)
            pw2 = np.linalg.inv(r) @ (np.linalg.inv(k) @ p2 * depth_min - t)
            depth_num = (1 / depth_min - 1 / depth_max) / (
                1 / depth_min - 1 / (depth_min + np.linalg.norm(pw2 - pw1)))
        else:
            depth_num = max_d
        depth_interval = (depth_max - depth_min) / (depth_num - 1) / interval_scale
        depth_ranges[i + 1] = (depth_min, depth_interval, depth_num, depth_max)

    # pairwise view-selection score (vectorized over shared points)
    cam_centers = {i: -extrinsic[i][:3, :3].T @ extrinsic[i][:3, 3]
                   for i in images}
    point_sets = {i: set(int(p) for p in images[i].point3D_ids if p != -1)
                  for i in images}
    score = np.zeros((num_images, num_images))
    for i in range(num_images):
        for j in range(i + 1, num_images):
            shared = point_sets[i + 1] & point_sets[j + 1]
            if not shared:
                continue
            xyz = np.stack([points3d[p].xyz for p in shared])
            vi = cam_centers[i + 1][None] - xyz
            vj = cam_centers[j + 1][None] - xyz
            cos = np.sum(vi * vj, axis=1) / (
                np.linalg.norm(vi, axis=1) * np.linalg.norm(vj, axis=1))
            theta = np.degrees(np.arccos(np.clip(cos, -1, 1)))
            sigma = np.where(theta <= theta0, sigma1, sigma2)
            s = float(np.sum(np.exp(-(theta - theta0) ** 2 / (2 * sigma ** 2))))
            score[i, j] = score[j, i] = s

    view_sel = []
    for i in range(num_images):
        order = np.argsort(score[i])[::-1]
        view_sel.append([(int(k), float(score[i, k]))
                         for k in order[:num_src_views]])

    # write cams / pair / images
    for i in range(num_images):
        with open(os.path.join(cam_dir, f"{i:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n")
            for row in extrinsic[i + 1]:
                f.write(" ".join(str(v) for v in row) + " \n")
            f.write("\nintrinsic\n")
            for row in intrinsic[images[i + 1].camera_id]:
                f.write(" ".join(str(v) for v in row) + " \n")
            d = depth_ranges[i + 1]
            f.write(f"\n{d[0]:f} {d[1]:f} {d[2]:f} {d[3]:f}\n")
    with open(os.path.join(save_folder, "pair.txt"), "w") as f:
        f.write(f"{num_images}\n")
        for i, sel in enumerate(view_sel):
            f.write(f"{i}\n{len(sel)} ")
            for image_id, s in sel:
                f.write(f"{image_id} {s:f} ")
            f.write("\n")
    for i in range(num_images):
        src = os.path.join(image_dir, images[i + 1].name)
        dst = os.path.join(image_out_dir, f"{i:08d}.jpg")
        if src.endswith(".jpg"):
            shutil.copyfile(src, dst)
        else:
            import cv2
            cv2.imwrite(dst, cv2.imread(src))
    log_fn(f"converted {num_images} views to {save_folder}")
    return num_images


def main(argv=None):
    p = argparse.ArgumentParser("colmap2mvsnet")
    p.add_argument("--dense_folder", required=True)
    p.add_argument("--save_folder", required=True)
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--theta0", type=float, default=5)
    p.add_argument("--sigma1", type=float, default=1)
    p.add_argument("--sigma2", type=float, default=10)
    p.add_argument("--model_ext", default=".bin", choices=[".txt", ".bin"])
    args = p.parse_args(argv)
    convert_scene(args.dense_folder, args.save_folder, args.max_d,
                  args.interval_scale, args.theta0, args.sigma1, args.sigma2,
                  args.model_ext)


if __name__ == "__main__":
    main()
